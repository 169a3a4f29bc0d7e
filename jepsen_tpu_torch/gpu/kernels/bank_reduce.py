"""Row reduction of the bank balance matrix: wrapper of the CUDA kernel
(csrc/bank_reduce.cu) and its plain PyTorch version.

Both compute what the device branch of
jepsen_tpu/workloads/bank.py:98-103 computes, in int64:

  mat   int64 [reads, accounts]
  -> (sums int64 [reads], negs bool [reads])  row sums, "any negative"

The matrix may have any number of columns and may be a contiguous view
whose first element is 8- but not 16-byte aligned (mat[1:] of an odd
width): the kernel reads such rows' odd elements alone.

bank_reduce() launches the kernel for CUDA tensors and runs
bank_reduce_reference() for CPU tensors; it never runs the plain version
on the card. `launches` counts kernel launches, and so does the
telemetry counter `bank.kernel.launches` (a stored run's metrics.json).
The launch is built by launch_plan(), which the lint (gpu/lint.py) also
calls on meta tensors.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ... import telemetry
from . import LaunchPlan, build

launches = 0

_lib_lock = threading.Lock()
_lib_cache: list = []


def _lib() -> ctypes.CDLL:
    with _lib_lock:
        if not _lib_cache:
            lib = build.load("bank_reduce")
            p = ctypes.c_void_p
            lib.bank_reduce_launch.argtypes = [p, ctypes.c_longlong,
                                               ctypes.c_int, p, p, p]
            lib.bank_reduce_launch.restype = ctypes.c_int
            lib.bank_reduce_error_string.argtypes = [ctypes.c_int]
            lib.bank_reduce_error_string.restype = ctypes.c_char_p
            _lib_cache.append(lib)
        return _lib_cache[0]


def _check(mat: torch.Tensor) -> None:
    if mat.dtype != torch.int64:
        raise TypeError(f"mat must be int64, got {mat.dtype}")
    if mat.dim() != 2:
        raise ValueError(f"mat must be [reads, accounts], got "
                         f"{tuple(mat.shape)}")
    if not mat.is_contiguous():
        raise ValueError("mat must be contiguous")
    if mat.data_ptr() % 8:
        raise ValueError(f"mat must be 8-byte aligned, starts at "
                         f"{mat.data_ptr():#x}")
    if mat.shape[1] >= 2 ** 31:
        raise ValueError(f"{mat.shape[1]} columns: at most 2**31 - 1")


def launch_plan(mat: torch.Tensor) -> LaunchPlan:
    """The launch bank_reduce() makes on a CUDA matrix: the matrix
    checked, the outputs allocated on its device and the call's
    parameters (the kernel takes no scratch and no dynamic shared
    memory)."""
    _check(mat)
    rows, cols = mat.shape
    dev = mat.device
    return LaunchPlan(
        args={"mat": mat},
        outputs={"sums": torch.empty(rows, dtype=torch.int64, device=dev),
                 "negs": torch.empty(rows, dtype=torch.bool, device=dev)},
        params={"rows": rows, "cols": cols})


def _submit(lib, plan: LaunchPlan, stream) -> int:
    """Calls bank_reduce_launch with the plan's tensors and parameters
    in the C signature's order; returns its CUDA error code."""
    o = plan.outputs
    return lib.bank_reduce_launch(plan.args["mat"].data_ptr(),
                                  *plan.params.values(),
                                  o["sums"].data_ptr(),
                                  o["negs"].data_ptr(), stream)


def bank_reduce(mat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(row sums, row has a negative) of an int64 [reads, accounts]
    matrix (see the module docstring)."""
    global launches
    dev = mat.device
    if dev.type == "cpu":
        _check(mat)
        return bank_reduce_reference(mat)
    if dev.type != "cuda":
        raise ValueError(f"bank_reduce runs on cuda or cpu, not {dev}")
    plan = launch_plan(mat)  # checks the matrix
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _submit(lib, plan, stream)
    if rc != 0:
        raise RuntimeError(
            f"bank_reduce launch failed: CUDA error {rc} "
            f"({lib.bank_reduce_error_string(rc).decode()}); "
            f"{plan.params}")
    if plan.params["rows"]:
        # the checkers of a composed check launch from worker threads
        with _lib_lock:
            launches += 1
        telemetry.count("bank.kernel.launches")
    return plan.outputs["sums"], plan.outputs["negs"]


def bank_reduce_reference(mat: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version."""
    return mat.sum(1), (mat < 0).any(1)
