"""Card-only tests of the port: each hand-written CUDA kernel against its
plain PyTorch version on the same CUDA tensors (bit-equal where both are
exact; attention within the tolerance stated at each test), a small
``ABTree`` on the card against the ``DictOracle``, a small serve engine and
one training step on the card against the same on the CPU.  Marked ``gpu``; they
skip on a host without a CUDA card.  Run on the card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``."""
import math

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
from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.elim_combine import kernel as ec_kernel  # noqa: E402
from repro_torch.kernels.elim_combine.ref import elim_combine_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.leaf_probe import kernel as lp_kernel  # noqa: E402
from repro_torch.kernels.leaf_probe.ref import leaf_probe_ref  # noqa: E402
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


def _pool(b, n_keys, *, fan=None, leaf=None, shards=1, scratch_leaf=True, seed=0):
    """A stacked (S, N, b) pool of search trees built bottom-up, as the
    tree lays them out: each shard's ``n_keys`` distinct keys fill leaves
    of ``leaf`` = (lo, hi) keys (1..b by default) in shuffled slots (EMPTY
    elsewhere); internal nodes take
    ``fan`` = (lo, hi) children (2..b by default), routers the least key of
    children 1.., EMPTY routers and NULL (-1) children past the last.  Row
    N-1 is the scratch row (EMPTY keys; a leaf unless ``scratch_leaf`` is
    False, when NULL-child lanes walk to max_height).  Returns the pool's
    tensors on the CPU, each shard's keys and the tallest shard's height."""
    rng = np.random.default_rng(seed)
    lo_fan, hi_fan = fan or (2, b)
    lo_leaf, hi_leaf = leaf or (1, b)
    shards_rows, roots, all_keys, height = [], [], [], 0
    for _ in range(shards):
        keys = np.sort(rng.choice(10**9, size=n_keys, replace=False)).astype(np.int64)
        rows = []  # (keys, vals, children, is_leaf)
        level, cut = [], 0
        while cut < n_keys:
            k = keys[cut: cut + int(rng.integers(lo_leaf, hi_leaf + 1))]
            cut += k.size
            slots = rng.permutation(b)[: k.size]
            rk = np.full(b, EMPTY, np.int64)
            rk[slots] = k
            rows.append((rk, rng.integers(-(2**40), 2**40, b), np.full(b, -1, np.int32), True))
            level.append((len(rows) - 1, int(k.min())))
        h = 1
        while len(level) > 1:
            up, cut = [], 0
            while cut < len(level):
                kids = level[cut: cut + int(rng.integers(lo_fan, hi_fan + 1))]
                cut += len(kids)
                rk = np.full(b, EMPTY, np.int64)
                rk[: len(kids) - 1] = [m for _, m in kids[1:]]
                ch = np.full(b, -1, np.int32)
                ch[: len(kids)] = [r for r, _ in kids]
                rows.append((rk, np.zeros(b, np.int64), ch, False))
                up.append((len(rows) - 1, kids[0][1]))
            level, h = up, h + 1
        shards_rows.append(rows)
        roots.append(level[0][0])
        all_keys.append(keys)
        height = max(height, h)
    n = max(len(r) for r in shards_rows) + 3  # free rows, then the scratch row
    pk = np.full((shards, n, b), EMPTY, np.int64)
    pv = np.zeros((shards, n, b), np.int64)
    ch = np.full((shards, n, b), -1, np.int32)
    lf = np.ones((shards, n), bool)
    for s_, rows in enumerate(shards_rows):
        for r, (rk, rv, rc, leaf) in enumerate(rows):
            pk[s_, r], pv[s_, r], ch[s_, r], lf[s_, r] = rk, rv, rc, leaf
    lf[:, n - 1] = scratch_leaf
    pool = tuple(torch.as_tensor(x) for x in (pk, pv, ch, lf))
    return (*pool, torch.as_tensor(roots, dtype=torch.int32)), all_keys, height


def _probe_queries(keys, bsz, rng, *, sort=False, dup_pool=0, empty_every=10):
    """Hits, misses (every third from bsz/3 on) and EMPTY lanes (NOPs, which
    count every router and take a NULL child past a non-full node);
    ``dup_pool`` > 0 draws the lanes from that many keys, key-sorted."""
    src = rng.choice(keys, size=dup_pool, replace=False) if dup_pool else keys
    q = rng.choice(src, size=bsz).astype(np.int64)
    if not dup_pool:
        q[bsz // 3:: 3] = rng.integers(0, 10**9, len(q[bsz // 3:: 3]))
    q[::empty_every] = EMPTY
    q[-1] = EMPTY
    return np.sort(q) if sort else q


# (b, n_keys, pool options, shards, bsz, query options); "grown": the tree
# grown by ABTree rounds
DESCEND_CASES = {
    "1": ("grown", 1), "37": ("grown", 37), "4096": ("grown", 4096),
    "root-leaf": (8, 5, dict(leaf=(8, 8)), 1, 64, {}),
    "tall-b4": (4, 700, dict(fan=(2, 2)), 1, 4096, {}),  # 9+ levels
    "b2": (2, 5000, {}, 1, 4096, {}),  # the narrowest group
    "b4": (4, 20_000, {}, 1, 4096, {}),
    "b8": (8, 20_000, {}, 1, 4096, {}),
    "b11": (11, 50_000, {}, 1, 16_384, {}),
    "b16": (16, 20_000, {}, 1, 4096, {}),
    "b24-warp-group": (24, 20_000, {}, 1, 4096, {}),  # the warp, one slot a lane
    "b40-looping-group": (40, 20_000, {}, 1, 4096, {}),
    "S2": (11, 20_000, {}, 2, 4096, {}),
    "sorted-dups": (11, 50_000, {}, 1, 16_384, dict(sort=True, dup_pool=40)),
    "empty-null": (8, 3000, dict(fan=(2, 5), scratch_leaf=False), 1, 2048, dict(empty_every=2)),
}


@pytest.mark.parametrize("case", list(DESCEND_CASES))
def test_descend_probe_kernel_equals_plain(cuda, case):
    spec = DESCEND_CASES[case]
    if spec[0] == "grown":
        bsz = spec[1]
        t, keys = _grown(cuda)
        rng = np.random.default_rng(bsz)
        q = rng.choice(keys, size=bsz).astype(np.int64)
        q[bsz // 3 :: 3] = rng.integers(0, 10**6, len(q[bsz // 3 :: 3]))
        q[-1] = EMPTY  # NOP lane
        st = t.stacked
        pool = (st.keys, st.vals, st.children, st.is_leaf, st.root)
        queries = torch.as_tensor(q, device=cuda)[None]
        max_height = t.cfg.max_height
    else:
        b, n_keys, popts, shards, bsz, qopts = spec
        pool, keys, height = _pool(b, n_keys, shards=shards, seed=b + n_keys, **popts)
        assert height == 1 if case == "root-leaf" else height >= (9 if case == "tall-b4" else 2)
        pool = tuple(x.to(cuda) for x in pool)
        rng = np.random.default_rng(bsz)
        queries = torch.as_tensor(
            np.stack([_probe_queries(k, bsz, rng, **qopts) for k in keys]), device=cuda)
        max_height = height + 4
    kw = dict(max_height=max_height, notfound=NOTFOUND)
    got = td_kernel.descend_probe_cuda(*pool, queries, **kw)
    want = descend_probe_ref(*pool, queries, **kw)
    for g, w, name in zip(got, want, ("leaf", "found", "slot", "val")):
        _eq(g, w, name)
    if case == "empty-null":  # lanes that took a NULL child report -1
        assert bool((want[0] == -1).any())


@pytest.mark.parametrize("bsz,m,f,density", [
    (1, 96, 8, 0.1), (300, 96, 8, 0.5), (64, 1200, 64, 0.3), (7, 96, 8, 1.0),
    (5, 96, 8, 0.0),
    (1, 72, 8, 0.3), (1024, 72, 8, 0.1),  # the serving indexes' rows (b = 8)
    (1, 1, 1, 1.0), (9, 1024, 100, 0.1), (9, 1025, 100, 0.1),  # the warp mode's ends
    (1, 2400, 200, 0.08), (3, 24_000, 2048, 0.08),  # rows after a wide scan
    (2, 24_000, 2048, 0.0), (2, 24_000, 2048, 1.0),
])
def test_frontier_compact_kernel_equals_plain(cuda, bsz, m, f, density):
    """The finished (frontier, valid, overflow) of the one-launch kernel
    against the plain version's, on rows a warp takes and rows a block
    takes, overflowing and not."""
    gen = torch.Generator(device="cpu").manual_seed(m * f + bsz)
    cand = torch.randint(0, 4096, (bsz, m), generator=gen, dtype=torch.int32).to(cuda)
    valid = (torch.rand((bsz, m), generator=gen) < density).to(cuda)
    got = td_kernel.frontier_compact_cuda(cand, valid, f, scratch=4097)
    want = frontier_compact_plain(cand, valid, f, scratch=4097)
    for g, w, name in zip(got, want, ("frontier", "valid", "overflow")):
        _eq(g, w, name)


def _combine_rows(bsz, row_keys, seed):
    """(S, B) combine inputs, one row per entry of ``row_keys``: key-sorted
    ops over that many distinct keys (None: every op its own key), random
    ops 0-3 and values, present0/val0 broadcast per segment.  A row whose
    key count is negative starts inside a segment (no head at op 0)."""
    rng = np.random.default_rng(seed)
    rows = []
    for n_keys in row_keys:
        keys = np.arange(bsz) if n_keys is None else np.sort(rng.integers(0, abs(n_keys), bsz))
        head = np.ones(bsz, bool)
        head[1:] = keys[1:] != keys[:-1]
        if n_keys is not None and n_keys < 0:
            head[0] = False
        seg = np.cumsum(head) - 1
        p0 = (rng.random(seg.max() + 2) < 0.5)[seg]
        v0 = rng.integers(-(2**62), 2**62, seg.max() + 2)[seg].astype(np.int64)
        rows.append((rng.integers(0, 4, bsz).astype(np.int32),
                     rng.integers(-(2**62), 2**62, bsz).astype(np.int64), head, p0, v0))
    return tuple(np.stack(x) for x in zip(*rows))


@pytest.mark.parametrize("bsz,row_keys", [
    pytest.param(16, (3,), id="16-3"), pytest.param(1000, (7,), id="1000-7"),
    pytest.param(5000, (200,), id="5000-200"), pytest.param(70000, (50,), id="70000-50"),
    pytest.param(1, (1,), id="1-op"),
    # (k, d): k of the kernel's tiles and d ops: one op short of a tile, on
    # it, one past it; two tiles and one op, every op its own segment
    pytest.param((1, -1), (40,), id="tile-1"), pytest.param((1, 0), (40,), id="tile"),
    pytest.param((1, 1), (40,), id="tile+1"), pytest.param((2, 1), (None,), id="2tiles+1-all-heads"),
    pytest.param(70000, (1,), id="70000-one-key"),  # one segment over every tile
    pytest.param(5000, (1, 300, -20), id="S3"),  # one key / many / no head at op 0
])
def test_elim_combine_kernel_equals_plain(cuda, bsz, row_keys):
    if isinstance(bsz, tuple):
        bsz = bsz[0] * ec_kernel.tile_ops() + bsz[1]
    args = tuple(torch.as_tensor(x, device=cuda)
                 for x in _combine_rows(bsz, row_keys, bsz + len(row_keys)))
    got = ec_kernel.elim_combine_cuda(*args)
    want = elim_combine_ref(*args)
    for g, w, name in zip(got, want, ("bp", "bv", "ap", "av")):
        _eq(g, w, name)


def test_elim_combine_graph_replay_equals_eager(cuda):
    """A CUDA graph of three back-to-back calls, replayed twice in a row on
    new inputs and once on the first ones, equals eager calls: the
    look-back scratch is left cleared by every call, eager or replayed."""
    bsz = 16_384

    def inputs(seed):
        return tuple(torch.as_tensor(x, device=cuda) for x in _combine_rows(bsz, (900,), seed))

    args = inputs(1)
    eager = ec_kernel.elim_combine_cuda(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # sizes the capture stream's scratch
        ec_kernel.elim_combine_cuda(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = [ec_kernel.elim_combine_cuda(*args) for _ in range(3)]
    for seed in (2, 2, 3):
        for dst, src in zip(args, inputs(seed)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want = ec_kernel.elim_combine_cuda(*args)
        for out in outs:
            for g, w in zip(out, want):
                assert torch.equal(g, w)
    for dst, src in zip(args, inputs(1)):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(outs[-1], eager):
        assert torch.equal(g, w)


def test_elim_combine_on_two_streams_at_once(cuda):
    """Calls on two streams that run at the same time each take their own
    look-back scratch: both agree with the plain version, round after
    round."""
    bsz = 16_384
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    args = [tuple(torch.as_tensor(x, device=cuda) for x in _combine_rows(bsz, (900,), seed))
            for seed in (5, 6)]
    wants = [elim_combine_ref(*a) for a in args]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(8):
        for k, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[k].append(ec_kernel.elim_combine_cuda(*args[k]))
    torch.cuda.synchronize()
    for k in range(2):
        for out in outs[k]:
            for g, w, name in zip(out, wants[k], ("bp", "bv", "ap", "av")):
                _eq(g, w, name)


@pytest.fixture(scope="module")
def one_call_kernels():
    """The device kernels of one B7 call (the serving shape), one K3, K2
    and K4 call (the tree path's shapes: K2 1,024 x 96 -> 8, K4 1,024 x 88
    at cap 128), one K4 call in block mode (2 x 3,000 at cap 4,096) and one
    B5 call (1,024 rows of 11),
    keyed by each call's first kernel name, counted in this file's only
    ``torch.profiler`` session: a short second session in one process has
    come back with no device events at all.  Each call runs once before the
    session (built, K3's scratch sized), then once inside it between
    synchronizes, so the device events come in call order: a call's run
    from its first kernel up to the next call's.  Returns those kernels and
    what the launch counters added for each call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device("cuda")
    q, k, v = _decode_inputs(cuda)
    combine = tuple(torch.as_tensor(x, device=cuda) for x in _combine_rows(16_384, (900,), 4))
    gen = torch.Generator(device="cpu").manual_seed(7)
    cand = torch.randint(0, 4096, (1024, 96), generator=gen, dtype=torch.int32).to(cuda)
    cvalid = (torch.rand((1024, 96), generator=gen) < 0.1).to(cuda)
    ck = torch.randint(0, 2000, (1024, 88), generator=gen).to(cuda)
    lo = torch.randint(0, 2000, (1024,), generator=gen).to(cuda)
    hi = lo + 64
    bk = torch.randint(0, 2000, (2, 3000), generator=gen).to(cuda)
    rows = ck[:, :11].contiguous()
    calls = {
        "decode_cluster_kernel": lambda: da_kernel.decode_attention_cuda(q, k, v, 543, 0.125),
        "elim_combine_kernel": lambda: ec_kernel.elim_combine_cuda(*combine),
        "compact_warp_rows": lambda: td_kernel.frontier_compact_cuda(cand, cvalid, 8, scratch=5),
        "range_scan_warp_rows": lambda: rs_kernel.range_scan_cuda(ck, ck, lo, hi, cap=128),
        "range_scan_sort_runs": lambda: rs_kernel.range_scan_cuda(bk, bk, lo[:2], hi[:2], cap=4096),
        "leaf_probe_groups": lambda: lp_kernel.leaf_probe_cuda(rows, rows, lo),
    }
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    counted = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, fn in calls.items():
            before = sum(c.launches for c in _lib.COUNTERS.values())
            fn()
            torch.cuda.synchronize()
            counted[name] = sum(c.launches for c in _lib.COUNTERS.values()) - before
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    names = list(calls)
    kernels = {name: [] for name in names}
    at = -1
    for e in events:
        if at + 1 < len(names) and names[at + 1] in e.name:
            at += 1
        assert at >= 0, f"device event {e.name!r} before the first call's kernel"
        kernels[names[at]].append(e.name)
    return kernels, counted


@pytest.mark.parametrize("name", ["compact_warp_rows", "range_scan_warp_rows"])
def test_scan_kernels_are_one_kernel_a_call(cuda, one_call_kernels, name):
    """One K2 call writes the finished frontier, valid plane and overflow,
    and one K4 call its four outputs, each in one kernel on the card (no
    fill, copy or elementwise finish around it)."""
    assert len(one_call_kernels[0][name]) == 1, one_call_kernels


@pytest.mark.parametrize("name", ["compact_warp_rows", "elim_combine_kernel",
                                  "range_scan_warp_rows", "range_scan_sort_runs",
                                  "decode_cluster_kernel", "leaf_probe_groups"])
def test_launch_counters_count_the_kernels_a_call_ran(cuda, one_call_kernels, name):
    """A call adds to its launch counter the number of kernels it ran on the
    card: one, but two in K4's block mode (sort the runs, then rank)."""
    kernels, counted = one_call_kernels
    assert counted[name] == len(kernels[name]), one_call_kernels
    if name == "range_scan_sort_runs":
        assert len(kernels[name]) == 2 and "range_scan_rank_runs" in kernels[name][1], kernels


def test_elim_combine_is_one_kernel_with_no_memset(cuda, one_call_kernels):
    """One call at the tree path's width is one kernel on the card: the
    look-back scratch needs no memset (the kernel clears what it used)."""
    kernels = one_call_kernels[0]["elim_combine_kernel"]
    assert len(kernels) == 1, one_call_kernels


@pytest.mark.parametrize("bsz,n,cap,dup,every", [
    (3, 88, 128, False, False), (64, 176, 16, True, False), (5, 3000, 4096, True, False),
    (2, 40, 8192, False, False),
    (1024, 88, 128, False, False), (16, 64, 256, True, False),  # tree path; evict_range's cap
    (3, 256, 128, True, True), (3, 257, 128, True, True),  # the warp mode's last n, the block's first
    (2, 9000, 8193, True, False), (2, 24_000, 20_000, True, False),  # caps past 8,192
    (2, 9000, 8193, True, True), (2, 24_000, 20_000, True, True),  # every slot matches
])
def test_range_scan_kernel_equals_plain(cuda, bsz, n, cap, dup, every):
    """Warp mode and block mode against the plain version, at every cap:
    EMPTY holes and duplicate keys, or (``every``) rows whose every slot is
    a match, so that a cap below n truncates."""
    rng = np.random.default_rng(n + cap)
    keys = rng.integers(0, 5000 if dup else 10**9, (bsz, n)).astype(np.int64)
    if not every:
        keys[rng.random((bsz, n)) < 0.3] = EMPTY
    vals = rng.integers(0, 10**6, (bsz, n)).astype(np.int64)
    lo = np.zeros(bsz, np.int64) if every else rng.integers(0, 2500, bsz).astype(np.int64)
    hi = np.full(bsz, 10**9, np.int64) if every else lo + rng.integers(0, 10**9, bsz)
    args = tuple(torch.as_tensor(x, device=cuda) for x in (keys, vals, lo, hi))
    got = rs_kernel.range_scan_cuda(*args, cap=cap)
    want = range_scan_ref(*args, cap)
    for g, w, name in zip(got, want, ("keys", "vals", "count", "truncated")):
        _eq(g, w, name)
    if every:
        assert bool((want[3] == (n > cap)).all())


def test_scan_round_past_cap_8192_equals_oracle(cuda):
    """``ABTree.scan_round`` on the card at cap 10,000 over an interval of
    more than 10,000 live keys (the frontier grows to fit), and at the
    interval's own count, equals ``DictOracle.range``: keys, values, count
    and truncated."""
    rng = np.random.default_rng(11)
    t, o = ABTree(TreeConfig(capacity=4096, b=11, a=2, max_height=24), device=cuda), DictOracle()
    keys = rng.choice(60_000, size=30_000, replace=False).astype(np.int64)
    vals = rng.integers(0, 10**9, keys.size).astype(np.int64)
    starts = [0] + list(range(256, keys.size, 8192))  # a narrow first round seeds the leaves
    for i, j in zip(starts, starts[1:] + [keys.size]):
        ops = np.full(j - i, OP_INSERT, np.int32)
        t.apply_round(ops, keys[i:j], vals[i:j])
        o.apply_round(ops, keys[i:j], vals[i:j])
    lo, hi, cap = 5_000, 45_000, 10_000
    want = o.range(lo, hi)
    assert len(want) > cap
    for c in (cap, len(want)):
        out = t.scan_round([lo, 0], [hi, 0], cap=c)
        n = int(out.count[0])
        assert n == min(len(want), c) and bool(out.truncated[0]) == (len(want) > c)
        assert list(zip(out.keys[0, :n].tolist(), out.vals[0, :n].tolist())) == want[:c]
        assert int(out.count[1]) == 0
    assert t._scan_frontier > 8  # the frontier grew past its first width


@pytest.mark.parametrize(
    "b,h,kh,s,d,kv_len,dtype",
    [(8, 14, 2, 1024, 64, 1024, torch.bfloat16),  # qwen2-0.5b serving shape, G = 7
     (8, 14, 2, 1024, 64, 517, torch.bfloat16),
     (3, 14, 2, 1000, 64, 1, torch.float32),
     (2, 8, 2, 777, 128, 700, torch.float32),
     (1, 16, 1, 300, 128, 299, torch.bfloat16),  # G = 16 at D = 128
     (2, 4, 4, 64, 64, 33, torch.float32),
     (4, 4, 2, 128, 32, 77, torch.bfloat16),  # reduced configs' head dim
     # one block a cluster, a block's range ending inside a warp step, eight
     # blocks (the serving call), a full cache; B = 1: two clusters
     (1, 14, 2, 1024, 64, 1, torch.bfloat16),
     (1, 14, 2, 1024, 64, 31, torch.bfloat16),
     (1, 14, 2, 1024, 64, 33, torch.bfloat16),
     (1, 14, 2, 1024, 64, 543, torch.bfloat16),
     (1, 14, 2, 1024, 64, 1024, torch.bfloat16),
     (2, 32, 2, 600, 128, 517, torch.bfloat16),  # G = 16 at D = 128, two passes of 8 rows
     (1, 64, 1, 64, 32, 64, torch.bfloat16),  # G·D = 2048 at D = 32: eight passes
     # group 1: zamba2-1.2b's shared block (32 heads of 64) and whisper-tiny's
     # self-attention (6 heads, s_max 448); whisper's cross-attention over
     # all 1,500 encoder frames (kv_len == S)
     (8, 32, 32, 512, 64, 300, torch.bfloat16),
     (8, 6, 6, 448, 64, 73, torch.bfloat16),
     (8, 6, 6, 1500, 64, 1500, torch.bfloat16),
     (2, 6, 6, 1500, 64, 1500, torch.float32)],
)
def test_decode_attention_kernel_equals_plain(cuda, b, h, kh, s, d, kv_len, dtype):
    """Cluster kernel against the plain version on the same CUDA tensors:
    f32 within 1e-5 (summation order); bf16 within 2 bf16 ulps at the
    output's largest magnitude (both round one f32 result once)."""
    gen = torch.Generator(device="cpu").manual_seed(b * s + kv_len)
    q = torch.randn((b, h, d), generator=gen).to(cuda, dtype)
    k = torch.randn((b, kh, s, d), generator=gen).to(cuda, dtype)
    v = torch.randn((b, kh, s, d), generator=gen).to(cuda, dtype)
    scale = 1.0 / d**0.5
    got = da_kernel.decode_attention_cuda(q, k, v, kv_len, scale)
    want = decode_attention_ref(q, k, v, kv_len)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        top = float(want.abs().max())
        ulp = torch.finfo(dtype).eps * 2.0 ** math.floor(math.log2(top))
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2 * ulp, (err, top)
    else:
        torch.testing.assert_close(got.float().cpu(), want.float().cpu(), atol=1e-5, rtol=1e-5)
    # columns past kv_len are never read: poisoning them changes nothing
    k[:, :, kv_len:] = float("nan")
    v[:, :, kv_len:] = float("nan")
    again = da_kernel.decode_attention_cuda(q, k, v, kv_len, scale)
    assert torch.equal(again, got)


def _decode_inputs(cuda, b=8, h=14, kh=2, s=1024, d=64, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return tuple(torch.randn(sh, generator=gen).to(cuda, torch.bfloat16)
                 for sh in ((b, h, d), (b, kh, s, d), (b, kh, s, d)))


def test_decode_attention_is_one_kernel_with_no_workspace(cuda, one_call_kernels):
    """One call at the serving shape is one kernel on the card (the cluster
    merges its partials itself) and allocates only its output."""
    kernels = one_call_kernels[0]["decode_cluster_kernel"]
    assert len(kernels) == 1, one_call_kernels
    q, k, v = _decode_inputs(cuda)
    da_kernel.decode_attention_cuda(q, k, v, 543, 0.125)  # built and warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    before = torch.cuda.memory_allocated(cuda)
    out = da_kernel.decode_attention_cuda(q, k, v, 543, 0.125)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(cuda) - before <= -(-out.numel() * out.element_size() // 512) * 512


def test_decode_attention_graph_replay_equals_eager(cuda):
    """Captured in a CUDA graph (as a decode step's graph would hold it) and
    replayed on new cache contents, the call equals an eager call."""
    q, k, v = _decode_inputs(cuda, seed=1)
    eager = da_kernel.decode_attention_cuda(q, k, v, 543, 0.125)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da_kernel.decode_attention_cuda(q, k, v, 543, 0.125)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da_kernel.decode_attention_cuda(q, k, v, 543, 0.125)
    for seed in (2, 3):
        for dst, src in zip((q, k, v), _decode_inputs(cuda, seed=seed)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, da_kernel.decode_attention_cuda(q, k, v, 543, 0.125))
    for dst, src in zip((q, k, v), _decode_inputs(cuda, seed=1)):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_decode_attention_limits_named(cuda):
    q = torch.zeros((1, 4, 48), device=cuda)
    k = torch.zeros((1, 2, 8, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        da_kernel.decode_attention_cuda(q, k, k, 4, 1.0)
    q = torch.zeros((1, 4, 64), device=cuda)
    k = torch.zeros((1, 2, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="kv_len"):
        da_kernel.decode_attention_cuda(q, k, k, 9, 1.0)


def _ulps_at_max(want, n=2):
    top = float(want.abs().max())
    return n * torch.finfo(want.dtype).eps * 2.0 ** math.floor(math.log2(top))


def _poisoned(shape, dtype, gen, cuda):
    """A contiguous tensor whose storage runs on past its end into NaN: a
    kernel that read key rows at or past S would meet them."""
    n = math.prod(shape)
    buf = torch.full((n + 4096,), float("nan"), dtype=dtype, device=cuda)
    buf[:n] = torch.randn(n, generator=gen).to(cuda, dtype)
    return buf[:n].view(shape)


@pytest.mark.parametrize(
    "b,h,kh,s,d,causal,window,dtype",
    [(2, 14, 2, 1024, 64, True, 0, torch.bfloat16),  # qwen2-0.5b training shape, G = 7
     (1, 14, 2, 1000, 64, False, 0, torch.bfloat16),  # ragged S, not causal
     (2, 8, 2, 777, 64, True, 256, torch.bfloat16),  # sliding window
     (1, 32, 32, 300, 80, True, 0, torch.bfloat16),  # h2o-danube-1.8b's D = 80
     (1, 8, 1, 200, 128, True, 0, torch.float32),  # MQA at D = 128
     (2, 4, 2, 130, 32, True, 48, torch.float32),  # reduced configs' head dim, window
     (1, 4, 4, 65, 80, False, 0, torch.float32),
     (3, 4, 2, 1, 64, True, 0, torch.float32),  # one row
     # bf16 on the tensor cores: S off the 128-row block and the 64-column
     # tile, D = 80 (a zero-filled second box) and 128, window edges inside
     # a tile, G = 7 and MQA
     (3, 14, 2, 1, 64, True, 0, torch.bfloat16),
     (1, 14, 2, 65, 64, True, 0, torch.bfloat16),
     (2, 14, 2, 129, 64, True, 0, torch.bfloat16),
     (1, 8, 1, 1000, 128, True, 0, torch.bfloat16),  # MQA at D = 128
     (1, 4, 2, 129, 80, False, 0, torch.bfloat16),
     (2, 7, 1, 333, 80, True, 100, torch.bfloat16),
     (1, 14, 2, 1000, 128, True, 37, torch.bfloat16),
     (2, 4, 2, 130, 32, True, 48, torch.bfloat16),
     (1, 6, 2, 300, 64, False, 70, torch.bfloat16),  # window without causality
     # group 1: whisper-tiny's encoder (6 heads, 1,500 frames: ragged, not
     # causal), its decoder, zamba2-1.2b's shared block (32 heads)
     (2, 6, 6, 1500, 64, False, 0, torch.bfloat16),
     (2, 6, 6, 448, 64, True, 0, torch.bfloat16),
     (1, 32, 32, 1024, 64, True, 0, torch.bfloat16),
     (1, 6, 6, 1500, 64, False, 0, torch.float32)],
)
def test_flash_attention_kernel_equals_plain(cuda, b, h, kh, s, d, causal, window, dtype):
    """Forward kernel against the plain version on the same CUDA tensors:
    f32 within 1e-5 (summation order); bf16 within 2 bf16 ulps at the
    output's largest magnitude (both round one f32 result once).  Key rows
    past S are NaN in memory and must never be read."""
    gen = torch.Generator(device="cpu").manual_seed(b * s + d + window)
    q = torch.randn((b, h, s, d), generator=gen).to(cuda, dtype)
    k = _poisoned((b, kh, s, d), dtype, gen, cuda)
    v = _poisoned((b, kh, s, d), dtype, gen, cuda)
    scale = 1.0 / d**0.5
    got = fa_kernel.flash_attention_cuda(q, k, v, causal=causal, window=window, sm_scale=scale)
    want = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert not torch.isnan(got).any()
    if dtype == torch.bfloat16:
        err = float((got.float() - want.float()).abs().max())
        assert err <= _ulps_at_max(want), (err, float(want.abs().max()))
    else:
        torch.testing.assert_close(got.cpu(), want.cpu(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40), (False, 0)])
def test_flash_attention_gradients_equal_plain_autograd(cuda, causal, window):
    """The Function's backward is the plain version's autograd on the saved
    inputs, so its grads equal plain autograd's bit for bit; the backward
    launches no kernel."""
    gen = torch.Generator(device="cpu").manual_seed(7)
    q, k, v, w = (torch.randn(sh, generator=gen).to(cuda, torch.bfloat16) for sh in
                  ((2, 14, 300, 64), (2, 2, 300, 64), (2, 2, 300, 64), (2, 14, 300, 64)))
    grads = []
    for fn in (fa_ops.flash_attention,
               lambda *a: attention_ref(*a[:3], causal=causal, window=window)):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*xs, causal, window)
        before = fa_kernel.FLASH_ATTENTION.launches
        (out.float() * w.float()).sum().backward()
        assert fa_kernel.FLASH_ATTENTION.launches == before
        grads.append([x.grad for x in xs])
    for a, b_ in zip(*grads):
        assert torch.equal(a, b_)


def test_flash_attention_bf16_runs_on_the_tensor_cores(cuda):
    """The bf16 instances are built on wgmma: the library's SASS holds HGMMA
    instructions."""
    import subprocess
    from pathlib import Path

    lib = _lib.build_all()["flash_attention"]
    cuobjdump = Path("/usr/local/cuda/bin/cuobjdump")
    sass = subprocess.run([str(cuobjdump) if cuobjdump.exists() else "cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    assert sum("HGMMA" in line for line in sass.splitlines()) > 0


def test_flash_attention_limits_named(cuda):
    q = torch.zeros((1, 2, 8, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa_kernel.flash_attention_cuda(q, q, q, causal=True, window=0, sm_scale=1.0)
    q = torch.zeros((1, 3, 8, 64), device=cuda)
    k = torch.zeros((1, 2, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="kv heads"):
        fa_kernel.flash_attention_cuda(q, k, k, causal=True, window=0, sm_scale=1.0)


LEAF_DTYPES = [(torch.int32, torch.int32), (torch.int32, torch.int64),
               (torch.int64, torch.int32), (torch.int64, torch.int64)]


@pytest.mark.parametrize("kdt,vdt", LEAF_DTYPES, ids=lambda d: str(d).split(".")[-1])
@pytest.mark.parametrize("b", [2, 4, 8, 11, 16, 24, 40, 64])  # 40, 64: two 32-slot steps
@pytest.mark.parametrize("bsz", [1, 1001, 70_000])  # 1001: no multiple of the rows a block takes
def test_leaf_probe_kernel_equals_plain(cuda, bsz, b, kdt, vdt):
    """B5 on seeded rows: hits at every slot, duplicate keys in a row (the
    first wins), misses whose keys share the query's low 32 bits, and
    all-EMPTY rows."""
    rng = np.random.default_rng(bsz * 100 + b)
    top = np.iinfo(np.int64 if kdt == torch.int64 else np.int32).max
    hi = 2**62 if kdt == torch.int64 else 2**30
    keys = rng.integers(-hi, hi, (bsz, b))
    keys[:, b // 2] = keys[:, b - 1]  # duplicates: the first slot wins
    queries = rng.integers(-hi, hi, bsz)
    hits = rng.random(bsz) < 0.6
    queries[hits] = keys[hits, rng.integers(0, b, bsz)[hits]]
    if kdt == torch.int64:  # same low 32 bits, other high bits
        keys[~hits, 0] = queries[~hits] ^ (1 << 40)
    keys[rng.random(bsz) < 0.1] = top  # all-EMPTY rows
    vals = rng.integers(-(2**30), 2**30, (bsz, b))
    args = (torch.as_tensor(keys, dtype=kdt, device=cuda),
            torch.as_tensor(vals, dtype=vdt, device=cuda),
            torch.as_tensor(queries, dtype=kdt, device=cuda))
    got = lp_kernel.leaf_probe_cuda(*args)
    want = leaf_probe_ref(*args)
    _eq(got[0], want[0], "slot")
    _eq(got[1], want[1], "val")
    assert got[1].dtype == vdt
    if bsz > 1:  # the rows hold hits and misses
        assert bool((want[0] >= 0).any()) and bool((want[0] < 0).any())


@pytest.mark.parametrize("kdt,vdt", LEAF_DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_leaf_probe_kernel_equals_plain_at_the_tree_paths_rows(cuda, kdt, vdt):
    """The tree path's shape: 16,384 rows of b = 11."""
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 2**30, (16_384, 11))
    queries = np.where(rng.random(16_384) < 0.5, keys[:, 7], rng.integers(0, 2**30, 16_384))
    args = (torch.as_tensor(keys, dtype=kdt, device=cuda),
            torch.as_tensor(rng.integers(0, 2**30, (16_384, 11)), dtype=vdt, device=cuda),
            torch.as_tensor(queries, dtype=kdt, device=cuda))
    got, want = lp_kernel.leaf_probe_cuda(*args), leaf_probe_ref(*args)
    _eq(got[0], want[0], "slot")
    _eq(got[1], want[1], "val")


def test_leaf_probe_is_one_kernel_a_call(cuda, one_call_kernels):
    assert len(one_call_kernels[0]["leaf_probe_groups"]) == 1, one_call_kernels


@pytest.mark.parametrize("mode", ["elim", "occ"])
@pytest.mark.parametrize("shards", [1, 4])
def test_occ_tree_and_forest_on_card_match_oracle(cuda, mode, shards):
    """occ mode and a four-shard forest on the card: Zipf-skewed mixed
    rounds (duplicate keys, so occ runs sub-rounds; range lanes across the
    shard boundaries) lane for lane equal to the oracle, every tree kernel
    launched."""
    from repro_torch.core import ABForest, check_forest_invariants
    from repro_torch.data.workloads import zipf_keys

    _lib.reset_counts()
    rng = np.random.default_rng(17)
    cfg = TreeConfig(capacity=256, b=11, a=2, max_height=24)
    t = (ABTree(cfg, mode=mode, device=cuda) if shards == 1 else
         ABForest(shards, cfg, mode=mode, key_space=(0, 4000), device=cuda))
    o = DictOracle()
    for r in range(10):
        ops = rng.choice([OP_INSERT] * 3 + [OP_DELETE, OP_FIND, OP_RANGE], 512).astype(np.int32)
        keys = zipf_keys(rng, 512, 4000, 0.8)
        vals = rng.integers(0, 10**9, 512).astype(np.int64)
        vals[ops == OP_RANGE] = rng.integers(0, 400, int((ops == OP_RANGE).sum()))
        out = t.apply_round(ops, keys, vals, scan_cap=16)
        res, fnd, scans = o.apply_mixed_round(ops, keys, vals, cap=16)
        assert out.results.tolist() == res and out.found.tolist() == fnd, r
        for i, rows in enumerate(scans):
            if rows is not None:
                n = int(out.scan.count[i])
                assert list(zip(out.scan.keys[i, :n].tolist(), out.scan.vals[i, :n].tolist())) == rows
    if shards == 1:
        check_invariants(t.state, t.cfg)
    else:
        check_forest_invariants(t)
        assert list(t.scan_stream(900, 3100, cap=64)) == o.range(900, 3100)
    assert t.items() == o.items()
    if mode == "occ":
        assert t.stats()["subrounds"] > 10
    for name in ("descend_probe", "frontier_compact", "elim_combine", "range_scan"):
        assert _lib.COUNTERS[name].launches > 0, name


def test_train_step_on_card_matches_cpu(cuda):
    """One ``step_fn`` of reduced qwen2-0.5b (2 layers, f32, B6 on the card)
    against the same step on the CPU: loss within 1e-5, grad norm and the
    first moment (a tenth of the clipped grads) within rtol 1e-4 / atol
    1e-7 (f32 sums in another order), count equal, and params within twice
    the step's learning rate (AdamW's first step is about lr · sign(g),
    whose sign a grad near 0 may flip)."""
    from repro_torch.configs import get_config
    from repro_torch.models import backbone, reduced
    from repro_torch.models.params import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("qwen2-0.5b"))
    params = init_params(backbone.model_spec(cfg), "cpu", seed=2)
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab, (4, 64)),
                             dtype=torch.int32)
    step_fn = make_train_step(cfg)
    outs = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        _lib.reset_counts()
        outs[str(dev)] = step_fn(p, adamw_init(p), {"tokens": tokens.to(dev)}, 50)
        if dev != "cpu":
            assert fa_kernel.FLASH_ATTENTION.launches == cfg.n_layers
    a, b_ = outs["cpu"], outs[str(cuda)]
    torch.testing.assert_close(b_.metrics["loss"].cpu(), a.metrics["loss"], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(b_.metrics["grad_norm"].cpu(), a.metrics["grad_norm"],
                               atol=1e-7, rtol=1e-4)
    assert int(b_.opt_state.count) == int(a.opt_state.count) == 1
    for x, y in zip(tree_leaves(b_.opt_state.m), tree_leaves(a.opt_state.m)):
        torch.testing.assert_close(x.cpu(), y, atol=1e-7, rtol=1e-4)
    lr = float(a.metrics["lr"])
    for x, y in zip(tree_leaves(b_.params), tree_leaves(a.params)):
        assert float((x.cpu() - y).abs().max()) <= 2 * lr + 1e-6


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cross_apply_decode_on_card_equals_plain(cuda, dtype):
    """Whisper's one-token cross-attention over 1,500 encoder frames: on the
    card through the decode kernel, against the plain decode attention on
    the same projected CUDA tensors (bf16 within 2 ulps at the output's
    largest magnitude: both round one f32 result once; f32 within 1e-5),
    then through the output projection."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    from repro_torch.models.params import init_params

    cfg = get_config("whisper-tiny").replace(dtype=str(dtype).split(".")[1])
    p = init_params(attention.cross_spec(cfg), cuda, seed=4)
    gen = torch.Generator(device="cpu").manual_seed(4)
    x = torch.randn((8, 1, cfg.d_model), generator=gen).to(cuda, dtype)
    enc = torch.randn((8, cfg.enc_frames, cfg.d_model), generator=gen).to(cuda, dtype)
    before = da_kernel.DECODE_ATTENTION.launches
    got = attention.cross_apply(p, x, enc, cfg)
    assert da_kernel.DECODE_ATTENTION.launches == before + 1
    proj = lambda t, w: attention._proj(t, w, dtype)
    q, k, v = proj(x, p["wq"]), proj(enc, p["wk"]), proj(enc, p["wv"])
    o = decode_attention_ref(q[:, :, 0], k, v)
    kern = da_kernel.decode_attention_cuda(q[:, :, 0].contiguous(), k.contiguous(),
                                           v.contiguous(), cfg.enc_frames, cfg.d_head ** -0.5)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        assert float((kern.float() - o.float()).abs().max()) <= _ulps_at_max(o)
    else:  # f32: within 1e-5, as the f32 cases of the kernel's own test
        torch.testing.assert_close(kern, o, atol=1e-5, rtol=1e-5)
    hd = cfg.n_heads * cfg.d_head
    want = o.reshape(8, 1, hd) @ p["wo"].to(dtype).reshape(hd, -1)
    assert got.shape == want.shape == (8, 1, cfg.d_model)
    tol = 1e-4 if dtype == torch.float32 else 0.05
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-1.2b", "whisper-tiny"])
def test_recurrent_and_audio_families_on_card_match_cpu(cuda, arch):
    """Reduced xlstm, zamba2 and whisper (f32): ``forward_train`` and three
    ``forward_decode`` steps on the card (B6 and B7 where the family
    attends) against the same on the CPU within 1e-4 (f32 sums in another
    order), every cache entry too."""
    from repro_torch.configs import get_config
    from repro_torch.models import backbone, reduced
    from repro_torch.models.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config(arch))
    params = init_params(backbone.model_spec(cfg), "cpu", seed=5)
    rng = np.random.default_rng(5)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 32)), dtype=torch.int32)
    extra = ({"frames": torch.as_tensor(rng.standard_normal((2, cfg.enc_frames, cfg.d_model)),
                                        dtype=torch.float32)} if cfg.family == "audio" else None)
    outs = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        ex = None if extra is None else _to(extra, dev)
        _lib.reset_counts()
        logits = [backbone.forward_train(p, tokens.to(dev), cfg, ex)]
        cache = backbone.init_cache(cfg, 2, 16, dev)
        for pos in range(3):
            lg, cache = backbone.forward_decode(p, cache, tokens[:, pos].to(dev), pos, cfg)
            logits.append(lg)
        outs[str(dev)] = (logits, cache)
        if dev != "cpu" and cfg.family != "ssm":
            assert fa_kernel.FLASH_ATTENTION.launches > 0
            assert da_kernel.DECODE_ATTENTION.launches > 0
    (la, ca), (lb, cb) = outs["cpu"], outs[str(cuda)]
    for x, y in zip(lb, la):
        torch.testing.assert_close(x.cpu(), y, atol=1e-4, rtol=1e-4)
    assert set(cb) == set(ca)
    for name in ca:
        xs, ys = ((c[name],) if isinstance(c[name], torch.Tensor) else c[name] for c in (cb, ca))
        for x, y in zip(xs, ys):
            torch.testing.assert_close(x.cpu(), y, atol=1e-4, rtol=1e-4)


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


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def test_serve_engine_on_card_matches_cpu(cuda):
    """A small f32 engine on the card (decode attention and all four tree
    kernels launched) gives the tokens and index contents of the same
    engine on the CPU, serial and pipelined."""
    from repro_torch.models import backbone
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.params import init_params
    from repro_torch.serve import Request, ServeEngine

    cfg = ModelConfig(name="small", family="dense", n_layers=2, d_model=128, n_heads=4,
                      n_kv=2, d_ff=256, vocab=128, d_head=64, qkv_bias=True,
                      tie_embeddings=True, dtype="float32")
    params = init_params(backbone.model_spec(cfg), "cpu", seed=5)
    rng = np.random.default_rng(5)
    hot = rng.integers(0, 128, 260).tolist()
    reqs = [(rid, hot if rid % 3 else rng.integers(0, 128, 260).tolist()) for rid in range(6)]
    runs = {}
    for dev, pipelined in (("cpu", False), (cuda, False), (cuda, True)):
        _lib.reset_counts()
        eng = ServeEngine(cfg, max_batch=2, s_max=300, n_pages=6, pipelined=pipelined,
                          device=dev, params=_to(params, dev))
        for rid, prompt in reqs:
            eng.submit(Request(rid=rid, prompt=list(prompt), max_new=4))
        eng.run_until_done(max_ticks=500)
        runs[(str(dev), pipelined)] = ({r.rid: r.out for r in eng.done}, eng.index.tree.items(),
                                       eng.sessions.tree.items(), eng.stats()["cache_hit_blocks"])
        if dev != "cpu":  # the serving path's kernels: the tree's four and decode attention
            for name in ("descend_probe", "frontier_compact", "elim_combine", "range_scan",
                         "decode_attention"):
                assert _lib.COUNTERS[name].launches > 0, name
    want = runs[("cpu", False)]
    assert want[3] > 0
    for key, got in runs.items():
        assert got == want, key


# -- durability on the card -------------------------------------------------------


def _durable_rounds(n_rounds, seed, bsz=64, key_range=256):
    rng = np.random.default_rng(seed)
    return [(rng.choice([OP_INSERT, OP_DELETE], bsz).astype(np.int32),
             rng.integers(0, key_range, bsz).astype(np.int64),
             rng.integers(0, 1000, bsz).astype(np.int64)) for _ in range(n_rounds)]


def _journal_arrays(d):
    """Every npz array and every manifest field of a journal directory, but
    the fields that hang on the npz files' bytes (their zip members carry
    the time they were written): ``file_crcs`` values and ``checksum``."""
    import json
    import os

    out = {}
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        if name.endswith(".npz"):
            with np.load(path) as z:
                out[name] = {k: z[k] for k in z.files}
        elif name.startswith("MANIFEST"):
            m = json.load(open(path))
            m["file_crcs"] = sorted(m["file_crcs"])
            m.pop("checksum")
            out[name] = m
    return out


def _same_journal(a, b):
    ja, jb = _journal_arrays(a), _journal_arrays(b)
    assert list(ja) == list(jb)
    for name, x in ja.items():
        if name.endswith(".npz"):
            assert list(x) == list(jb[name]), name
            for k, v in x.items():
                assert v.dtype == jb[name][k].dtype and np.array_equal(v, jb[name][k]), (name, k)
        else:
            assert x == jb[name], name


@pytest.mark.parametrize("mode", ["elim", "occ"])
def test_durable_journal_on_card_equals_cpu(cuda, tmp_path, mode):
    """The same rounds through ``DurableABTree`` on the card and on the CPU
    write the same journal (deltas and a pool growth included); ``recover``
    on the card equals ``recover(device="cpu")`` state for state, and the
    recovered items equal the oracle's."""
    from repro_torch.core import DurableABTree, recover
    from repro_torch.interop import state_to_numpy

    cfg = TreeConfig(capacity=256, b=8, a=2, max_height=12)
    rounds = _durable_rounds(10, seed=5, key_range=4096)
    dirs = {dev: str(tmp_path / dev) for dev in ("cuda", "cpu")}
    oracle = DictOracle()
    for dev, d in dirs.items():
        t = DurableABTree(d, cfg, mode=mode, snapshot_every=3, full_snapshot_every=2, device=dev)
        for ops, keys, vals in rounds:
            t.apply_round(ops, keys, vals)
            if dev == "cuda":
                oracle.apply_round(ops.tolist(), keys.tolist(), vals.tolist())
        t.close()
    assert t.tree.cfg.capacity > cfg.capacity  # the pool grew
    _same_journal(dirs["cuda"], dirs["cpu"])
    on_card, on_cpu = recover(dirs["cuda"]), recover(dirs["cuda"], device="cpu")
    assert on_card.tree.stacked.keys.is_cuda
    a, b = state_to_numpy(on_card.tree.stacked), state_to_numpy(on_cpu.tree.stacked)
    for k in a:
        if k == "stats":
            continue
        assert np.array_equal(a[k], b[k]), k
    assert on_card.tree.items() == oracle.items()
    check_invariants(on_card.tree.state, on_card.tree.cfg)


def test_durable_segment_capture_copies_only_dirty_rows(cuda, tmp_path, monkeypatch):
    """A segment commit copies to the host only the rows it writes, and
    the whole pool only for a snapshot."""
    import os

    from repro_torch.core import DurableABTree, durable

    copied = []
    real = durable._to_host

    def spy(t):
        copied.append(tuple(t.shape))
        return real(t)

    cfg = TreeConfig(capacity=1024, b=8, a=2, max_height=12)
    t = DurableABTree(str(tmp_path / "j"), cfg, snapshot_every=1000, device="cuda")
    rounds = _durable_rounds(3, seed=9)
    t.apply_round(*rounds[0])
    monkeypatch.setattr(durable, "_to_host", spy)
    t.apply_round(*rounds[1])
    seg = sorted(f for f in os.listdir(t.dir) if "_segment_" in f)[-1]
    with np.load(os.path.join(t.dir, seg)) as z:
        n = z["node_ids"].size
    # one copy a persisted field, each of the segment's rows only
    assert [s[0] for s in copied] == [n] * 5 and n < cfg.capacity // 4
    copied.clear()
    t._force_snapshot.add(t._uids[0])
    t.apply_round(*rounds[2])
    assert [s[0] for s in copied] == [cfg.capacity + 1] * 5
    t.close()


# ---------------------------------------------------------------------------
# obs: the op audit on the card, a recorded card history through the witness
# ---------------------------------------------------------------------------


def _audit_batch(rng, n, key_range):
    ops = rng.choice([OP_INSERT, OP_DELETE, OP_FIND, OP_RANGE], n,
                     p=[0.45, 0.45, 0.05, 0.05]).astype(np.int32)
    keys = rng.integers(0, key_range, n).astype(np.int64)
    vals = np.where(ops == OP_RANGE, rng.integers(1, 65, n), rng.integers(0, 1 << 40, n))
    return ops, keys, vals.astype(np.int64)


@pytest.mark.parametrize("tree", ["jax_audit_tree", "b11_mixed_batch"])
def test_op_audit_on_card(cuda, tree):
    """The scan descent and the scan phase run no sort on the card, and each
    phase launches its hand-written kernels: K1 and K3 once each a search,
    K2 in the descent, K2 and K4 in the scan phase, each seen by the
    profiler (the audit itself raises otherwise; the counts are checked
    here again)."""
    from repro_torch.obs import op_audit

    if tree == "jax_audit_tree":
        out = op_audit.audit_search_phases()
    else:
        t, _ = _grown(cuda)
        out = op_audit.audit_search_phases(t, _audit_batch(np.random.default_rng(3), 4096, 10**6))
    for p in ("scan_descent", "scan_phase"):
        ops = op_audit.count_ops(out[p])
        assert ops["aten::sort"] == ops["aten::argsort"] == 0, (p, ops)
    repeat = op_audit.AUDIT_REPEAT
    assert op_audit.count_ops(out["search"])["aten::argsort"] == repeat  # the batch's key sort
    assert op_audit.wrapper_launches(out["search"], "search") == {"K1": repeat, "K3": repeat}
    for p, c in out.items():
        launched, seen = op_audit.wrapper_launches(c, p), op_audit.kernel_launches(c, p)
        assert all(0 < seen[k] <= launched[k] for k in launched), (p, launched, seen)


@pytest.mark.parametrize("mode", ["elim", "occ"])
@pytest.mark.parametrize("shards", [1, 4])
def test_recorded_card_history_passes_witness_and_equals_cpu(cuda, mode, shards):
    """The same mixed rounds (a fused scan + delete and a scan round at the
    end) on the card and on the CPU: the flight recorders' histories equal
    record for record and lane for lane, and the witness accepts them."""
    from repro_torch.core import ABForest
    from repro_torch.obs.recorder import Recorder
    from repro_torch.obs.witness import check_history

    cfg = TreeConfig(capacity=512, b=11, a=2, max_height=16)
    records = []
    for dev in (cuda, torch.device("cpu")):
        h = (ABTree(cfg, mode=mode, device=dev) if shards == 1 else
             ABForest(shards, cfg, mode=mode, key_space=(0, 4000), device=dev))
        h.recorder = Recorder(capacity=10_000)
        rng = np.random.default_rng(11)
        for _ in range(5):
            h.apply_round(*_audit_batch(rng, 512, 4000), scan_cap=32)
        h.scan_delete_round([0], [40], cap=16)
        h.scan_round([0], [4000], cap=64)
        records.append(h.recorder.records())
    assert records[0] == records[1]
    rep = check_history(records[0], collect_prefixes=True)
    assert rep.rounds == 7 and rep.lanes > 2500 and rep.state
    if mode == "elim":
        assert rep.eliminated > 0


def test_host_mesh_on_card_equals_meshfree(cuda):
    """On the 1-rank NCCL host mesh: a reduced qwen2 train step (DTensor
    params and AdamW state) gives the mesh-free step's loss and params bit
    for bit, with B6 once a layer in each; a serve step with its cache
    placed by ``cache_shardings`` gives ``forward_decode``'s logits bit for
    bit, with B7 once a layer in each; ``compressed_grad_reduce`` over a
    (pod=1, data=1, model=1) mesh equals ``dequantize_int8(_ef_quantize)``
    bit for bit.  No DTensor reaches a kernel launcher (the launches are
    counted where a launcher runs)."""
    from repro_torch._shardmap_compat import place
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh, make_mesh, shutdown
    from repro_torch.models import backbone, reduced
    from repro_torch.models.params import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.parallel import compress
    from repro_torch.parallel.sharding import cache_shardings
    from repro_torch.train import make_serve_step, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("qwen2-0.5b")).replace(dtype="bfloat16")
    params = init_params(backbone.model_spec(cfg), cuda, seed=3)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, (4, 64)),
                             dtype=torch.int32, device=cuda)
    try:
        mesh = make_host_mesh()
        outs, launches = [], []
        for m in (None, mesh):
            _lib.reset_counts()
            outs.append(make_train_step(cfg, m)(tree_map(torch.clone, params), adamw_init(params),
                                                {"tokens": tokens}, 3))
            launches.append(fa_kernel.FLASH_ATTENTION.launches)
        assert launches == [cfg.n_layers] * 2
        assert torch.equal(outs[0].metrics["loss"], outs[1].metrics["loss"])
        for a, b in zip(tree_leaves(outs[0].params), tree_leaves(outs[1].params)):
            assert torch.equal(a, b.full_tensor())
        want_cache = backbone.init_cache(cfg, 4, 64, cuda)
        cache = place(backbone.init_cache(cfg, 4, 64, cuda), cache_shardings(cfg, 4, 64, mesh))
        serve = make_serve_step(cfg, mesh, 4, 64)
        for pos in range(3):
            _lib.reset_counts()
            want, _ = backbone.forward_decode(params, want_cache, tokens[:, pos], pos, cfg)
            got, _ = serve(params, cache, tokens[:, pos], pos)
            assert da_kernel.DECODE_ATTENTION.launches == 2 * cfg.n_layers
            assert torch.equal(got.full_tensor(), want)
        mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
        g = {"w": torch.randn(3, 1000, device=cuda)}
        e = compress.init_error_feedback(g)
        mean, _ = compress.compressed_grad_reduce(g, e, mesh3)
        q, s, _ = compress._ef_quantize(g["w"], e["w"])
        assert torch.equal(mean["w"], compress.dequantize_int8(q, s, (3, 1000), torch.float32))
    finally:
        shutdown()


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "yi-34b"])
def test_mesh_train_step_at_the_archs_remat_equals_meshfree(cuda, arch):
    """On the 1-rank NCCL host mesh, a reduced train step at the arch's own
    ``remat`` (``dots`` for both) gives the mesh-free step's loss and params
    bit for bit: the card's autograd engine runs the recompute on a thread
    of its own, and it reruns the forward's local regions under the mesh."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh, shutdown
    from repro_torch.models import backbone, reduced
    from repro_torch.models.params import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config(arch))
    assert cfg.remat == "dots"
    params = init_params(backbone.model_spec(cfg), cuda, seed=5)
    tokens = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab, (4, 64)),
                             dtype=torch.int32, device=cuda)
    try:
        mesh = make_host_mesh()
        want, got = (make_train_step(cfg, m)(tree_map(torch.clone, params), adamw_init(params),
                                             {"tokens": tokens}, 3) for m in (None, mesh))
        assert torch.equal(want.metrics["loss"], got.metrics["loss"])
        for a, b in zip(tree_leaves(want.params), tree_leaves(got.params)):
            assert torch.equal(a, b.full_tensor())
    finally:
        shutdown()


PIPE_GRAD_TOL = 1e-5  # f32 gradients summed a microbatch at a time against one batched product


@pytest.mark.parametrize("placement", ["whole", "dtensor"])
def test_one_stage_pipeline_backward_on_card(cuda, placement):
    """A one-stage ``pipeline_apply`` on the 1-rank NCCL mesh: the output
    equals the stage's, and the gradients of ``sum(out * g)`` for the stage
    weights (whole, or a pod-split ``DTensor`` whose gradient keeps its
    placement) and the microbatches equal the stage's own autograd within
    ``PIPE_GRAD_TOL``."""
    from torch.distributed.tensor import DTensor

    from repro_torch._shardmap_compat import NamedSharding, PartitionSpec, distribute
    from repro_torch.launch.mesh import make_host_mesh, make_mesh, shutdown
    from repro_torch.parallel.pipeline import pipeline_apply

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(7)
    w = torch.randn((1, 64, 64), generator=gen, device=cuda) * 0.1
    xs = torch.randn((4, 8, 64), generator=gen, device=cuda)
    g = torch.randn((4, 8, 64), generator=gen, device=cuda)
    try:
        make_host_mesh()
        pmesh = make_mesh((1,), ("pod",), "cuda")
        wp = w if placement == "whole" else distribute(
            w, NamedSharding(pmesh, PartitionSpec("pod", None, None)))
        wp, xp = wp.detach().requires_grad_(), xs.clone().requires_grad_()
        out = pipeline_apply({"w": wp}, xp, lambda p, h: torch.tanh(h @ p["w"]), pmesh)
        gw, gx = torch.autograd.grad((out * g).sum(), [wp, xp])
    finally:
        shutdown()
    if placement == "dtensor":
        assert isinstance(gw, DTensor) and gw.placements == wp.placements
        gw = gw.full_tensor()
    wr, xr = w.clone().requires_grad_(), xs.clone().requires_grad_()
    stage = torch.tanh(xr @ wr[0])
    rw, rx = torch.autograd.grad((stage * g).sum(), [wr, xr])
    assert torch.equal(out.detach(), stage.detach())
    for got, want in ((gw, rw), (gx, rx)):
        assert got.is_cuda and float((got - want).abs().max()) <= PIPE_GRAD_TOL


def test_bare_state_forms_on_card_equal_cpu(cuda):
    """``core.abtree.frontier_expand`` over a grown tree's bare state on the
    card (each level compacted by K2, launched once a level) equals the same
    call on a CPU copy, all five outputs, at caps that overflow and caps
    that fit; ``descend`` + ``probe`` on the card equal K1's answers."""
    from repro_torch.core import abtree

    t, keys = _grown(cuda)
    st = t.state
    cpu = abtree.TreeState(*(x.cpu() for x in st[:-1]),
                           stats=abtree.TreeStats(*(x.cpu() for x in st.stats)))
    rng = np.random.default_rng(11)
    lo = rng.integers(0, 10**6, 1024).astype(np.int64)
    hi = lo + rng.integers(1, 65, 1024)
    lo[:4] = (0, 0, int(EMPTY), 10**5)
    hi[:4] = (int(EMPTY), 10**6, int(EMPTY), 10**5)  # everything, most, padding, empty
    for cap in (2, 8, 64):
        before = td_kernel.FRONTIER_COMPACT.launches
        got = abtree.frontier_expand(st, t.cfg, torch.as_tensor(lo, device=cuda),
                                     torch.as_tensor(hi, device=cuda), cap)
        assert td_kernel.FRONTIER_COMPACT.launches - before == t.cfg.max_height
        want = abtree.frontier_expand(cpu, t.cfg, torch.as_tensor(lo), torch.as_tensor(hi), cap)
        for g, w, name in zip(got, want, ("leaves", "cand_keys", "cand_vals", "touched",
                                          "overflow")):
            assert g.is_cuda
            _eq(g, w, f"cap {cap} {name}")
        assert bool(want[4][0]) and bool(want[4][1])  # hundreds of leaves: past every cap
    q = torch.as_tensor(np.concatenate([keys[:500], lo[:500]]), device=cuda)
    q[0] = int(EMPTY)
    leaf = abtree.descend(st, q, t.cfg)
    found, slot, val = abtree.probe(st, leaf, q)
    s = t.stacked
    k1 = td_ops.descend_probe(s.keys, s.vals, s.children, s.is_leaf, s.root, q[None],
                              max_height=t.cfg.max_height, notfound=int(NOTFOUND))
    for g, w, name in zip((leaf, found, slot, val), k1, ("leaf", "found", "slot", "val")):
        _eq(g, w[0], name)
