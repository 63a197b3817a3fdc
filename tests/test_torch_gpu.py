"""Card-only tests of the port: each hand-written CUDA kernel against its
plain PyTorch version on the same CUDA tensors (bit-equal), and a small
``ABTree`` on the card against the ``DictOracle``.  Marked ``gpu``; they
skip on a host without a CUDA card.  Run on the card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    ABTree,
    DictOracle,
    EMPTY,
    NOTFOUND,
    OP_DELETE,
    OP_FIND,
    OP_INSERT,
    OP_RANGE,
    TreeConfig,
    check_invariants,
)
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.elim_combine import kernel as ec_kernel  # noqa: E402
from repro_torch.kernels.elim_combine.ref import elim_combine_ref  # noqa: E402
from repro_torch.kernels.range_scan import kernel as rs_kernel  # noqa: E402
from repro_torch.kernels.range_scan.ref import range_scan_ref  # noqa: E402
from repro_torch.kernels.tree_descend import kernel as td_kernel  # noqa: E402
from repro_torch.kernels.tree_descend import ops as td_ops  # noqa: E402
from repro_torch.kernels.tree_descend.ref import (  # noqa: E402
    descend_probe_ref,
    frontier_compact_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _eq(a, b, name):
    assert torch.equal(a.cpu(), b.cpu()), name


def _grown(cuda, n_keys=3000, b=11, seed=0):
    rng = np.random.default_rng(seed)
    t = ABTree(TreeConfig(capacity=1024, b=b, a=2, max_height=24), device=cuda)
    keys = rng.choice(10**6, size=n_keys, replace=False).astype(np.int64)
    t.apply_round(np.full(n_keys, OP_INSERT, np.int32), keys, keys * 3)
    drop = keys[: n_keys // 4]
    t.apply_round(np.full(drop.size, OP_DELETE, np.int32), drop, np.zeros_like(drop))
    return t, keys


@pytest.mark.parametrize("bsz", [1, 37, 4096])
def test_descend_probe_kernel_equals_plain(cuda, bsz):
    t, keys = _grown(cuda)
    rng = np.random.default_rng(bsz)
    q = rng.choice(keys, size=bsz).astype(np.int64)
    q[bsz // 3 :: 3] = rng.integers(0, 10**6, len(q[bsz // 3 :: 3]))
    q[-1] = EMPTY  # NOP lane
    st = t.stacked
    args = (st.keys, st.vals, st.children, st.is_leaf, st.root,
            torch.as_tensor(q, device=cuda)[None])
    kw = dict(max_height=t.cfg.max_height, notfound=NOTFOUND)
    got = td_kernel.descend_probe_cuda(*args, **kw)
    want = descend_probe_ref(*args, **kw)
    for g, w, name in zip(got, want, ("leaf", "found", "slot", "val")):
        _eq(g, w, name)


@pytest.mark.parametrize("bsz,m,f,density", [(1, 96, 8, 0.1), (300, 96, 8, 0.5),
                                             (64, 1200, 64, 0.3), (7, 96, 8, 1.0),
                                             (5, 96, 8, 0.0)])
def test_frontier_compact_kernel_equals_plain(cuda, bsz, m, f, density):
    gen = torch.Generator(device="cpu").manual_seed(m * f)
    cand = torch.randint(0, 4096, (bsz, m), generator=gen, dtype=torch.int32).to(cuda)
    valid = (torch.rand((bsz, m), generator=gen) < density).to(cuda)
    got = td_ops.finish_compact(*td_kernel.frontier_compact_cuda(cand, valid, f), f, 4097)
    want = td_ops.finish_compact(*frontier_compact_plain(cand, valid, f), f, 4097)
    for g, w, name in zip(got, want, ("frontier", "valid", "overflow")):
        _eq(g, w, name)


@pytest.mark.parametrize("bsz,n_keys", [(16, 3), (1000, 7), (5000, 200), (70000, 50)])
def test_elim_combine_kernel_equals_plain(cuda, bsz, n_keys):
    rng = np.random.default_rng(bsz)
    keys = np.sort(rng.integers(0, n_keys, bsz))
    ops = rng.integers(0, 4, bsz).astype(np.int32)
    vals = rng.integers(-(2**62), 2**62, bsz).astype(np.int64)
    head = np.ones(bsz, bool)
    head[1:] = keys[1:] != keys[:-1]
    seg = np.cumsum(head) - 1
    p0 = (rng.random(seg.max() + 1) < 0.5)[seg]
    v0 = rng.integers(-(2**62), 2**62, seg.max() + 1)[seg].astype(np.int64)
    args = tuple(torch.as_tensor(x, device=cuda)[None] for x in (ops, vals, head, p0, v0))
    got = ec_kernel.elim_combine_cuda(*args)
    want = elim_combine_ref(*args)
    for g, w, name in zip(got, want, ("bp", "bv", "ap", "av")):
        _eq(g, w, name)


@pytest.mark.parametrize("bsz,n,cap,dup", [(3, 88, 128, False), (64, 176, 16, True),
                                           (5, 3000, 4096, True), (2, 40, 8192, False)])
def test_range_scan_kernel_equals_plain(cuda, bsz, n, cap, dup):
    rng = np.random.default_rng(n + cap)
    keys = rng.integers(0, 5000 if dup else 10**9, (bsz, n)).astype(np.int64)
    keys[rng.random((bsz, n)) < 0.3] = EMPTY
    vals = rng.integers(0, 10**6, (bsz, n)).astype(np.int64)
    lo = rng.integers(0, 2500, bsz).astype(np.int64)
    hi = lo + rng.integers(0, 10**9, bsz)
    args = tuple(torch.as_tensor(x, device=cuda) for x in (keys, vals, lo, hi))
    got = rs_kernel.range_scan_cuda(*args, cap=cap)
    want = range_scan_ref(*args, cap)
    for g, w, name in zip(got, want, ("keys", "vals", "count", "truncated")):
        _eq(g, w, name)


def test_range_scan_cap_limit_named(cuda):
    x = torch.zeros((1, 4), dtype=torch.int64, device=cuda)
    lo = torch.zeros((1,), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match=str(rs_kernel.MAX_CAP)):
        rs_kernel.range_scan_cuda(x, x, lo, lo, cap=rs_kernel.MAX_CAP + 1)


def test_abtree_on_card_matches_oracle(cuda):
    """Mixed rounds with splits, merges and truncated scans on the card,
    every kernel launched, lane-for-lane equal to the oracle."""
    _lib.reset_counts()
    rng = np.random.default_rng(3)
    cfg = TreeConfig(capacity=256, b=11, a=2, max_height=24)
    t, o = ABTree(cfg, device=cuda), DictOracle()
    for r in range(12):
        bsz = 512
        pool = [OP_INSERT] * 3 + [OP_DELETE, OP_FIND, OP_RANGE] if r < 8 else [OP_DELETE] * 3 + [OP_RANGE]
        ops = rng.choice(pool, bsz).astype(np.int32)
        keys = rng.integers(0, 3000, bsz).astype(np.int64)
        vals = rng.integers(0, 10**9, bsz).astype(np.int64)
        vals[ops == OP_RANGE] = rng.integers(0, 200, int((ops == OP_RANGE).sum()))
        out = t.apply_round(ops, keys, vals, scan_cap=8)
        res, fnd, scans = o.apply_mixed_round(ops, keys, vals, cap=8)
        assert out.results.tolist() == res
        assert out.found.tolist() == fnd
        for i, rows in enumerate(scans):
            if rows is not None:
                n = int(out.scan.count[i])
                assert list(zip(out.scan.keys[i, :n].tolist(), out.scan.vals[i, :n].tolist())) == rows
    check_invariants(t.state, t.cfg)
    assert t.items() == o.items()
    for name in ("descend_probe", "frontier_compact", "elim_combine", "range_scan"):
        assert _lib.COUNTERS[name].launches > 0, name
