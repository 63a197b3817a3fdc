"""Port parity of the publishing-elimination combine: ``repro_torch``'s
``eliminate_batch`` / ``op_return_values`` and the plain version of the
``elim_combine`` kernel against the JAX package (``repro.core.elimination``
and ``elim_combine_pallas`` in interpret mode).  Inputs are made from a seed
with numpy; every output is an integer or a bool, so the tolerance is zero
(``np.array_equal``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (enables jax x64 before any JAX input is built)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import elimination as jelim  # noqa: E402
from repro.kernels.elim_combine import elim_combine_pallas, elim_combine_ref as jelim_combine_ref  # noqa: E402
from repro_torch.core import elimination as telim  # noqa: E402
from repro_torch.kernels.elim_combine import elim_combine, elim_combine_ref  # noqa: E402

NOTFOUND = int(repro.core.NOTFOUND)


def _hypothesis_like(seed, n):
    """One input of tests/test_elimination.py's property test: n <= 100 ops
    of (op 0-3, val 1-50, segment head, present0), head forced at 0,
    val0 = 99 where present."""
    rng = np.random.default_rng(seed)
    ops = rng.integers(0, 4, n).astype(np.int32)
    vals = rng.integers(1, 51, n).astype(np.int64)
    head = rng.random(n) < 0.5
    head[0] = True
    p0 = rng.random(n) < 0.5
    v0 = np.where(p0, 99, 0).astype(np.int64)
    return ops, vals, head, p0, v0


def _single_key(seed, n):
    """tests/test_elimination.py's write-collapse input: n <= 60 ops on one
    key."""
    rng = np.random.default_rng(seed)
    ops = rng.integers(1, 4, n).astype(np.int32)
    vals = rng.integers(1, 100, n).astype(np.int64)
    head = np.zeros(n, bool)
    head[0] = True
    present = bool(rng.integers(0, 2))
    p0 = np.full(n, present)
    v0 = np.where(p0, 7, 0).astype(np.int64)
    return ops, vals, head, p0, v0


def _sorted_batch(bsz, n_keys, seed, broadcast=True):
    """Key-sorted batch with segments of random length (tests/test_kernels.py
    ``_mk_combine_batch``); long runs cross the 256-op TPU tile."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, n_keys, bsz))
    ops = rng.integers(0, 4, bsz).astype(np.int32)
    vals = rng.integers(1, 2**30, bsz).astype(np.int64)
    head = np.ones(bsz, bool)
    head[1:] = keys[1:] != keys[:-1]
    seg = np.cumsum(head) - 1
    p0 = rng.random(seg.max() + 1) < 0.5
    v0 = np.where(p0, rng.integers(1, 2**30, seg.max() + 1), 0).astype(np.int64)
    if broadcast:
        return ops, vals, head, p0[seg], v0[seg]
    # only the heads carry the pre-round state (eliminate_batch broadcasts)
    junk = rng.integers(0, 2**30, bsz)
    return ops, vals, head, np.where(head, p0[seg], rng.random(bsz) < 0.5), np.where(head, v0[seg], junk)


def _cross_tile():
    """tests/test_kernels.py:91: one hot key alternating insert/delete over
    many tiles."""
    bsz = 600
    ops = np.tile([2, 3], bsz // 2).astype(np.int32)
    vals = np.arange(bsz).astype(np.int64)
    head = np.zeros(bsz, bool)
    head[0] = True
    return ops, vals, head, np.zeros(bsz, bool), np.zeros(bsz, np.int64)


CASES = (
    [("hyp", _hypothesis_like(s, n)) for s, n in ((0, 100), (1, 100), (2, 100), (3, 37), (4, 37), (5, 1))]
    + [("single", _single_key(s, n)) for s, n in ((0, 60), (1, 60), (2, 60), (3, 1))]
    + [("sorted", _sorted_batch(1000, 7, 1, broadcast=False)),
       ("sorted", _sorted_batch(513, 200, 2, broadcast=False)),
       ("sorted", _sorted_batch(2048, 3, 3, broadcast=False)),
       ("cross_tile", _cross_tile())]
)


_jax_eliminate = jax.jit(jelim.eliminate_batch)


def _jax(args):
    return tuple(jnp.asarray(a) for a in args)


def _torch(args):
    return tuple(torch.as_tensor(a)[None] for a in args)


@pytest.mark.parametrize("idx", range(len(CASES)), ids=[f"{c[0]}{i}" for i, c in enumerate(CASES)])
def test_eliminate_batch_fields_equal_jax(idx):
    """Every EliminationResult field and the return values, bit-equal."""
    _, args = CASES[idx]
    want = _jax_eliminate(*_jax(args))
    got = telim.eliminate_batch(*_torch(args))
    for name in jelim.EliminationResult._fields:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()[0]
        assert np.array_equal(g, w), name
    ops = args[0]
    want_ret = jelim.op_return_values(jnp.asarray(ops), want, repro.core.NOTFOUND)
    got_ret = telim.op_return_values(torch.as_tensor(ops)[None], got, NOTFOUND)
    assert np.array_equal(got_ret.numpy()[0], np.asarray(want_ret))


@pytest.mark.parametrize(
    "bsz,n_keys,seed", [(16, 3, 0), (1000, 7, 2), (513, 200, 3), (600, 1, 4)]
)
def test_elim_combine_plain_equals_pallas_interpret(bsz, n_keys, seed):
    """The kernel's plain version against the Pallas kernel run in interpret
    mode on int32 inputs (broadcast present0/val0, the kernel contract),
    and against the JAX jnp reference on int64 inputs."""
    ops, vals, head, p0, v0 = _sorted_batch(bsz, n_keys, seed)
    vals32, v032 = vals.astype(np.int32), v0.astype(np.int32)
    pallas = elim_combine_pallas(*_jax((ops, vals32, head, p0, v032)), tile=256, interpret=True)
    jref = jax.jit(jelim_combine_ref)(*_jax((ops, vals, head, p0, v0)))
    got = elim_combine_ref(*_torch((ops, vals, head, p0, v0)))
    for g, p, r, name in zip(got, pallas, jref, ("bp", "bv", "ap", "av")):
        g = g.numpy()[0]
        assert np.array_equal(g, np.asarray(p).astype(g.dtype)), f"pallas {name}"
        assert np.array_equal(g, np.asarray(r)), f"jnp ref {name}"


def test_elim_combine_wrapper_takes_plain_version_on_cpu():
    ops, vals, head, p0, v0 = _sorted_batch(300, 5, 9)
    args = _torch((ops, vals, head, p0, v0))
    for g, w in zip(elim_combine(*args), elim_combine_ref(*args)):
        assert torch.equal(g, w)


def test_lane_masks_and_range_masking_equal_jax():
    ops = np.array([0, 1, 2, 3, 4, 4, 2, 0], np.int32)
    jp, jr = jelim.lane_masks(jnp.asarray(ops))
    tp, tr = telim.lane_masks(torch.as_tensor(ops))
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    assert np.array_equal(
        telim.mask_range_lanes(torch.as_tensor(ops)).numpy(),
        np.asarray(jelim.mask_range_lanes(jnp.asarray(ops))),
    )


def _take(t, idx):
    return telim.Transition(*(f[:, idx] for f in t))


def _where(m, a, b):
    return telim.Transition(*(torch.where(m, x, y) for x, y in zip(a, b)))


LOOK_BACK_CASES = {
    "sorted": _sorted_batch(3000, 40, 5),
    "one-key": _cross_tile(),  # one segment over every tile
    "all-heads": _sorted_batch(700, 10**9, 6),
    "hyp": _hypothesis_like(8, 100),
}


@pytest.mark.parametrize("tile", [1, 7, 256, 2048])
@pytest.mark.parametrize("case", list(LOOK_BACK_CASES))
def test_look_back_rule_gives_the_inclusive_transition(case, tile):
    """The algebra the CUDA kernel's decoupled look-back relies on: cut a
    row into tiles, compose each tile's aggregate with ``compose``, and
    fold the aggregates back from each tile to the first one whose segment
    flag is set (or to the row's first tile).  Composed with the tile's own
    aggregate, that is the inclusive transition at the tile's end: applied
    to a present and to an absent key it gives the JAX package's
    ``elim_combine_ref`` ``after`` there."""
    ops, vals, head, _, _ = LOOK_BACK_CASES[case]
    t = telim.op_transition(*_torch((ops, vals, head)))
    bsz = ops.size
    n_tiles = -(-bsz // tile)
    pad = n_tiles * tile - bsz
    ident = telim.identity_like(_take(t, torch.zeros(pad, dtype=torch.long)))
    t = telim.Transition(*(torch.cat([f, g], dim=1) for f, g in zip(t, ident)))
    starts = torch.arange(n_tiles) * tile
    agg = _take(t, starts)
    for u in range(1, tile):
        agg = telim.compose(agg, _take(t, starts + u))
    k = torch.arange(n_tiles)
    acc = telim.identity_like(agg)
    done = (k == 0)[None]
    stopped_on_flag = torch.zeros_like(done)
    for d in range(1, n_tiles):
        j = torch.clamp(k - d, min=0)
        p = _take(agg, j)
        active = ~done
        acc = _where(active, telim.compose(p, acc), acc)
        stopped_on_flag |= active & p.flag & (j > 0)[None]
        done = done | (active & (p.flag | (j == 0)[None]))
        if bool(done.all()):
            break
    incl = telim.compose(acc, agg)
    ends = (torch.clamp(starts + tile, max=bsz) - 1).numpy()
    for present in (True, False):
        p0 = np.full(bsz, present)
        v0 = np.full(bsz, 12345, dtype=np.int64)
        _, _, want_p, want_v = jax.jit(jelim_combine_ref)(*_jax((ops, vals, head, p0, v0)))
        got_p, got_v = telim.apply_transition(
            incl, torch.as_tensor(p0[:n_tiles])[None], torch.as_tensor(v0[:n_tiles])[None])
        assert np.array_equal(got_p.numpy()[0], np.asarray(want_p)[ends]), present
        assert np.array_equal(got_v.numpy()[0], np.asarray(want_v)[ends]), present
    if case == "sorted" and n_tiles > 2:  # many heads: some look-backs stop early
        assert bool(stopped_on_flag.any())
