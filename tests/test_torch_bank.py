"""Parity of the port's bank workload (workloads/bank.py and the plain
version of the kernel in gpu/kernels/bank_reduce.py) with the JAX
package's `jepsen_tpu.workloads.bank`.

On the workload's own balances the port equals JAX exactly, on the
narrow host fold (8 accounts) and on the wide device branch (32
accounts, >= 10,000 reads; the port runs the kernel's plain version
there, device="cpu"). Past int32 the JAX branch wraps (ROADMAP C1), so
exactness there is checked against the numpy fold instead. The CUDA
kernel itself runs only on a card: its test is skipped without CUDA,
and chip_smoke.py compares it with the plain version at full size.
"""

import numpy as np
import pytest
import torch

from jepsen_tpu.history import History as JHistory, op as jop
from jepsen_tpu.tpu import synth as jsynth
from jepsen_tpu.workloads import bank as jbank
from jepsen_tpu_torch.gpu import synth as psynth
from jepsen_tpu_torch.gpu.kernels import bank_reduce as kbank
from jepsen_tpu_torch.history import History as PHistory, op as pop
from jepsen_tpu_torch.workloads import bank as pbank

torch.set_num_threads(1)


def norm(x):
    if hasattr(x, "to_dict") and not isinstance(x, dict):
        return {"op": x.to_dict()}
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    return x


def _raise_balance(hist, at_frac, by=1):
    """A copy of a bank history with one balance of the first ok read
    at or after `at_frac` of the events raised by `by`."""
    ops = list(hist)
    for i in range(int(len(ops) * at_frac), len(ops)):
        o = ops[i]
        if o.type == "ok" and o.f == "read":
            v = dict(o.value)
            v[0] += by
            ops[i] = o.copy(value=v)
            return type(hist)(ops, assign_indices=False)
    raise ValueError("no ok read to corrupt")


def _to_jax(hist):
    return JHistory([jop(**o.to_dict()) for o in hist],
                    assign_indices=False)


@pytest.mark.parametrize("accounts,n_txns", [(8, 3000), (32, 3000),
                                             (32, 24_000)])
@pytest.mark.parametrize("corrupt", [False, True], ids=["valid", "bad"])
def test_check_fast_matches_jax(accounts, n_txns, corrupt):
    ph = psynth.bank_history(n_txns, n_accounts=accounts, seed=11)
    if corrupt:
        ph = _raise_balance(ph, 0.85)
    jh = _to_jax(ph)
    total = accounts * 10
    want = jbank.check_fast(jh, total)
    got = pbank.check_fast(ph, total, device="cpu")
    assert norm(got) == norm(want)
    assert got["valid?"] is (not corrupt)
    if n_txns > 20_000:
        assert got["read-count"] >= pbank.DEVICE_MIN_READS


def test_negative_balances_match_jax():
    ops = []
    for i in range(12_000):
        vals = {a: 10 for a in range(16)}
        if i % 997 == 5:
            vals[3], vals[4] = -4, 24
        ops += [pop(type="invoke", process=0, f="read"),
                pop(type="ok", process=0, f="read", value=vals)]
    ph = PHistory(ops)
    jh = _to_jax(ph)
    for negative_ok in (False, True):
        want = jbank.check_fast(jh, 160, negative_ok=negative_ok)
        got = pbank.check_fast(ph, 160, negative_ok=negative_ok,
                               device="cpu")
        assert norm(got) == norm(want)
    assert got["valid?"] is True
    assert not pbank.check_fast(ph, 160, device="cpu")["valid?"]


def test_sums_past_int32_equal_the_numpy_fold():
    """A row [2^31 - 1, 5, ...] wraps in the JAX branch; the port sums
    it in int64 like the numpy host fold."""
    big = 2 ** 31 - 1
    ops = []
    for i in range(11_000):
        vals = {a: 0 for a in range(16)}
        vals[0] = big if i % 2 else big + 5
        vals[1] = 5 if i % 2 else 0
        ops += [pop(type="invoke", process=0, f="read"),
                pop(type="ok", process=0, f="read", value=vals)]
    ops[-1] = ops[-1].copy(value={**ops[-1].value, 2: 1})
    ph = PHistory(ops)
    got = pbank.check_fast(ph, big + 5, device="cpu")
    want = jbank.check_fast(_to_jax(ph), big + 5, device=False)
    assert norm(got) == norm(want)
    assert got["error-count"] == 1
    assert got["first-error"]["found"] == big + 6
    mat = np.array([list(o.value.values()) for o in ph
                    if o.type == "ok"], dtype=np.int64)
    sums, negs = kbank.bank_reduce(torch.from_numpy(mat))
    np.testing.assert_array_equal(sums.numpy(), mat.sum(axis=1))
    assert not negs.any()


def test_checker_matches_jax():
    ph = _raise_balance(psynth.bank_history(2000, seed=4), 0.5)
    jh = _to_jax(ph)
    want = jbank.checker({"total-amount": 80}).check({}, jh)
    got = pbank.checker({"total-amount": 80, "device": "cpu"}).check({}, ph)
    assert norm(got) == norm(want)
    assert got["anomaly-classes"] == {"bank-imbalance": "witnessed"}


def test_generator_matches_jax():
    j = jbank.generator(seed=5)
    p = pbank.generator(seed=5)
    assert [p() for _ in range(500)] == [j() for _ in range(500)]


def test_plain_reduction_on_random_matrices():
    rng = np.random.default_rng(0)
    for rows, cols in ((0, 32), (1, 1), (37, 33), (1000, 32)):
        mat = rng.integers(-2 ** 40, 2 ** 40, (rows, cols), dtype=np.int64)
        sums, negs = kbank.bank_reduce(torch.from_numpy(mat))
        np.testing.assert_array_equal(sums.numpy(), mat.sum(axis=1))
        np.testing.assert_array_equal(negs.numpy(), (mat < 0).any(axis=1))


def test_wrapper_rejects_bad_inputs_and_counts_no_plain_launch():
    before = kbank.launches
    kbank.bank_reduce(torch.zeros((4, 3), dtype=torch.int64))
    assert kbank.launches == before
    with pytest.raises(TypeError):
        kbank.bank_reduce(torch.zeros((4, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        kbank.bank_reduce(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        kbank.bank_reduce(torch.zeros((4, 3), dtype=torch.int64).t())
    with pytest.raises(ValueError):
        kbank.bank_reduce(torch.zeros((4, 3), dtype=torch.int64,
                                      device="meta"))


def test_synth_bank_history_matches_jax():
    j = jsynth.bank_history(800, n_accounts=32, seed=11)
    p = psynth.bank_history(800, n_accounts=32, seed=11)
    assert [o.to_dict() for o in p] == [o.to_dict() for o in j]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def test_cuda_kernel_matches_plain(cuda_device):
    """Whole matrices and views one element into a buffer (rows off the
    16-byte grid), at odd and even widths."""
    rng = np.random.default_rng(1)
    shapes = ((1, 1), (1000, 1), (1000, 2), (1000, 3), (1000, 32),
              (250_000, 32), (77, 100))
    for (rows, cols), view in [(s, v) for s in shapes for v in (0, 1)]:
        host = torch.from_numpy(rng.integers(-2 ** 40, 2 ** 40, (rows, cols),
                                             dtype=np.int64))
        flat = torch.empty(rows * cols + view, dtype=torch.int64,
                           device=cuda_device)
        mat = flat[view:].view(rows, cols).copy_(host)
        before = kbank.launches
        got = kbank.bank_reduce(mat)
        assert kbank.launches == before + 1
        want = kbank.bank_reduce_reference(mat)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b.cpu())


def _offset_view(rows, cols, seed):
    """A contiguous [rows, cols] view one element into a buffer, so its
    first element is 8- but not 16-byte aligned (mat[1:] of a 3-column
    matrix is such a view)."""
    rng = np.random.default_rng(seed)
    flat = torch.tensor(rng.integers(-2 ** 40, 2 ** 40, rows * cols + 1,
                                     dtype=np.int64))
    return flat[1:].view(rows, cols)


@pytest.mark.parametrize("rows,cols", [(1000, 1), (1000, 2), (1000, 3),
                                       (77, 100), (500, 32), (9, 33)])
@pytest.mark.parametrize("view", [False, True], ids=["whole", "offset"])
def test_plain_reduction_on_odd_widths_and_views(rows, cols, view):
    """The shapes the kernel meets with a head or a tail: widths that
    are not a multiple of two elements, and views whose rows start off
    the 16-byte grid. The wrapper takes them all."""
    if view:
        mat = _offset_view(rows, cols, cols)
    else:
        mat = torch.from_numpy(np.random.default_rng(cols).integers(
            -2 ** 40, 2 ** 40, (rows, cols), dtype=np.int64))
    assert mat.is_contiguous()
    sums, negs = kbank.bank_reduce(mat)
    m = mat.numpy()
    np.testing.assert_array_equal(sums.numpy(), m.sum(axis=1))
    np.testing.assert_array_equal(negs.numpy(), (m < 0).any(axis=1))
    s2, n2 = kbank.bank_reduce_reference(mat)
    assert torch.equal(s2, sums) and torch.equal(n2, negs)


def test_wrapper_checks_alignment():
    """mat[1:] of a 3-column matrix starts 8 bytes off the 16-byte grid
    and is taken; an int64 tensor that is not even 8-byte aligned is
    refused before any launch."""
    view = torch.tensor(np.arange(33, dtype=np.int64).reshape(11, 3))[1:]
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    sums, _ = kbank.bank_reduce(view)
    np.testing.assert_array_equal(sums.numpy(), view.numpy().sum(axis=1))
    raw = torch.frombuffer(bytearray(8 * 13), dtype=torch.int64, count=12,
                           offset=4).view(4, 3)
    assert raw.data_ptr() % 8 == 4
    before = kbank.launches
    with pytest.raises(ValueError, match="aligned"):
        kbank.bank_reduce(raw)
    with pytest.raises(ValueError, match="contiguous"):
        kbank.bank_reduce(torch.zeros((4, 6), dtype=torch.int64)[:, ::2])
    assert kbank.launches == before
