"""One run of one cell of the benchmark of jepsen_tpu_torch, the PyTorch
and CUDA port, on the NVIDIA cards of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> \
        --seconds <window> --trace <0|1>

Run from the root of a checkout. The cell, its configuration, traffic
mix and metrics are those BENCHMARK.json names. The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics with --trace 0, its per-layer
metrics with --trace 1), `device`, with --trace 1 `breakdown`, and last
`compared`, each number the comparison with the reference made beside
its limit; standard error ends with the same numbers. Exits non-zero,
with no result, where the card is missing, where the program cannot be
imported, or where the process holds JAX or the JAX package at the end.

The kernels' build cache and every other cache the program keeps live
under perfbench/cache/ in the checkout, so a checkout's first run builds
and later runs load.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402 — set-up is counted from the first line
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / "cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "jepsen_tpu")


def _environment() -> None:
    """Fixed cache directories inside the checkout, set before the
    program or torch is imported."""
    os.environ["JEPSEN_TPU_COMPILE_CACHE"] = str(CACHE / "kernels")
    os.environ["JEPSEN_TPU_NATIVE_DIR"] = str(CACHE / "native")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared whole."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _environment()
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT))
    from harness import cell

    spec = cell.resolve(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        print(f"cell {args.workload} needs {spec['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2

    def log(msg: str) -> None:
        print(f"[perfbench] {msg}", file=sys.stderr, flush=True)

    kernels = CACHE / "kernels"
    before = sorted(p.name for p in kernels.glob("*")) if kernels.is_dir() \
        else []
    result = cell.run(spec, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_PROCESS, log=log)
    after = sorted(p.name for p in kernels.glob("*"))
    log(f"kernel build cache: {len(before)} files before the run, "
        f"{len(after)} after")
    bad = forbidden_modules()
    if bad:
        print(f"the process holds {', '.join(bad)}: the benchmark "
              "measures jepsen_tpu_torch alone", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"{name} {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
