"""chip_smoke's phase 6 holds the headline's wgl_search launches against
ONE call of the plain version a search shape (`plain_against`). These
tests hold that batched call to the plain version run on each launch
alone, on the CPU: the same per-row outputs, the largest level count,
the summed level series, and any changed output of any launch seen.
"""

from __future__ import annotations

import pytest
import torch

import chip_smoke
from jepsen_tpu_torch.checker import models
from jepsen_tpu_torch.gpu import synth, wgl
from jepsen_tpu_torch.gpu.encode import encode
from jepsen_tpu_torch.gpu.kernels import wgl_search as ws

DEV = torch.device("cpu")


def _launch(seeds, ops, reach, corrupt=()):
    """(packed, row_seg, st0, kw, out) of one launch over the register
    histories of `seeds` (those in `corrupt` damaged halfway), every
    state a start in reach mode, the initial state otherwise."""
    m = models.cas_register()
    hs = []
    for s in seeds:
        h = synth.register_history(ops, n_procs=4, seed=s, crash_p=0.05)
        if s in corrupt:
            h = synth.corrupt_register_history(h, at_frac=0.5)[0]
        hs.append(h)
    encs = [encode(m, h) for h in hs]
    pb = wgl.PackedBatch(encs)
    rows = ([(i, s) for i, e in enumerate(encs) for s in range(e.n_states)]
            if reach else [(i, e.init_state) for i, e in enumerate(encs)])
    packed, rs, s0 = pb.tensors(*pb.rows(rows), DEV)
    kw = dict(W=24, F=48, max_iters=pb.M + 4, reach=reach,
              crash_free=not pb.has_crashed)
    return packed, rs, s0, kw, ws.wgl_search(packed, rs, s0, **kw)


@pytest.fixture(scope="module", params=[True, False],
                ids=["reach", "verdict"])
def group(request):
    """Launches of one search shape, of different rows, segments and
    level counts (the headline's waves)."""
    reach = request.param
    out = [_launch([1], 120, reach), _launch([2, 3, 4], 120, reach,
                                             corrupt=(3,)),
           _launch([5, 6], 120, reach)]
    keys = {chip_smoke.plain_group_key(x[0], x[3]) for x in out}
    assert len(keys) == 1, keys
    return out


def test_one_plain_call_equals_each_launch_alone(group):
    err, plain_ms = chip_smoke.plain_against(group)
    assert err == 0 and plain_ms >= 0
    # the batched call's rows, level count and series, against each
    # launch's plain version run alone
    alone = [ws.wgl_search_reference(p, rs, s0, **kw)
             for p, rs, s0, kw, _ in group]
    for a, (_, _, _, _, out) in zip(alone, group):
        assert chip_smoke._max_abs_err(out, a) == 0
    assert len({int(a[-4]) for a in alone}) > 1


@pytest.mark.parametrize("where", ["row", "levels", "series"])
def test_a_changed_output_of_any_launch_is_seen(group, where):
    # the launch of fewest levels: its count is not the call's
    i = min(range(len(group)), key=lambda j: int(group[j][4][-4]))
    packed, rs, s0, kw, out = group[i]
    out = [t.clone() for t in out]
    if where == "row":
        out[0][0] = out[0][0] ^ 1 if out[0].dtype != torch.bool \
            else ~out[0][0]
    elif where == "levels":
        out[-4] = out[-4] + 1
    else:
        out[-2][0] += 1
    bad = list(group)
    bad[i] = (packed, rs, s0, kw, tuple(out))
    err, _ = chip_smoke.plain_against(bad)
    assert err > 0
