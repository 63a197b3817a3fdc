"""Port parity of the tree_descend kernels' plain versions: ``descend_probe``
on a pool grown by the JAX ``ABTree`` and carried across with
``repro_torch.interop``, against the JAX int64 reference and the Pallas
kernel in interpret mode; ``frontier_compact`` against the argsort oracle
and the interpreted Pallas kernel over a sweep of shapes.  Integer outputs,
zero tolerance (``np.array_equal``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402  (enables jax x64 before any JAX input is built)
import jax.numpy as jnp  # noqa: E402

from repro.core import ABTree as JTree, EMPTY, NOTFOUND, OP_DELETE, OP_INSERT, TreeConfig as JConfig  # noqa: E402
from repro.kernels.tree_descend import (  # noqa: E402
    descend_probe as jdescend_probe,
    descend_probe_ref as jdescend_probe_ref,
    frontier_compact as jfrontier_compact,
    frontier_compact_ref as jfrontier_compact_ref,
)
from repro_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.kernels.tree_descend import (  # noqa: E402
    descend_probe,
    descend_ref,
    frontier_compact,
    frontier_compact_plain,
    frontier_compact_ref,
    probe_ref,
)


def _state_dict(jstate):
    d = {k: np.asarray(v) for k, v in jstate._asdict().items() if k != "stats"}
    d["stats"] = {k: np.asarray(v) for k, v in jstate.stats._asdict().items()}
    return d


@pytest.fixture(scope="module", params=[8, 11], ids=["b8", "b11"])
def grown(request):
    """A multi-level JAX tree with EMPTY holes in its leaves
    (tests/test_tree_descend.py ``_grown_tree``), at b = 8 and b = 11."""
    b = request.param
    rng = np.random.default_rng(0)
    t = JTree(JConfig(capacity=512, b=b, a=2, max_height=12))
    keys = rng.choice(10**6, size=300, replace=False).astype(np.int64)
    t.apply_round(np.full(300, OP_INSERT, np.int32), keys, keys * 3)
    drop = keys[:75]
    t.apply_round(np.full(75, OP_DELETE, np.int32), drop, np.zeros_like(drop))
    return t, np.setdiff1d(keys, drop), state_from_numpy(_state_dict(t.state))


def _queries(live, bsz, seed):
    rng = np.random.default_rng(seed)
    q = rng.choice(live, size=bsz).astype(np.int64)
    q[bsz // 3 :: 3] = rng.integers(0, 10**6, len(q[bsz // 3 :: 3]))  # misses
    if bsz > 2:
        q[-1] = int(EMPTY)  # masked NOP lane
        q[0] = int(EMPTY)
    return q


def test_interop_round_trip(grown):
    t, _, st = grown
    want = _state_dict(t.state)
    back = state_to_numpy(st)
    for name, w in want.items():
        if name == "stats":
            for k, v in w.items():
                assert np.array_equal(back["stats"][k][0], v), k
        else:
            assert np.array_equal(back[name][0], w), name
            assert back[name][0].dtype == w.dtype or name in ("root", "height"), name


@pytest.mark.parametrize("bsz", [7, 64, 200])
def test_descend_probe_plain_equals_jax(grown, bsz):
    """leaf, found, slot, val lane for lane against the JAX int64 ref and the
    interpreted Pallas kernel, including misses and EMPTY (NOP) lanes, whose
    NULL child b-1 goes to the scratch row."""
    t, live, st = grown
    q = _queries(live, bsz, bsz)
    s = t.state
    jargs = (s.keys, s.vals, s.children, s.is_leaf, s.root, jnp.asarray(q))
    kw = dict(max_height=t.cfg.max_height, notfound=NOTFOUND)
    ref = jdescend_probe_ref(*jargs, **kw)
    pallas = jdescend_probe(*jargs, **kw, narrow=True)
    got = descend_probe(
        st.keys, st.vals, st.children, st.is_leaf, st.root, torch.as_tensor(q)[None],
        max_height=t.cfg.max_height, notfound=int(NOTFOUND),
    )
    for g, r, p, name in zip(got, ref, pallas, ("leaf", "found", "slot", "val")):
        g = g.numpy()[0]
        r, p = np.asarray(r), np.asarray(p)
        assert np.array_equal(g, r), f"ref {name}"
        assert np.array_equal(g, p), f"pallas {name}"
    # the unfused halves of the plain version agree with the fused call
    leaf_h = descend_ref(
        st.keys, st.children, st.is_leaf, st.root, torch.as_tensor(q)[None],
        max_height=t.cfg.max_height,
    )
    assert np.array_equal(leaf_h.numpy()[0], got[0].numpy()[0])
    found_h, slot_h, val_h = probe_ref(
        st.keys, st.vals, leaf_h, torch.as_tensor(q)[None], notfound=int(NOTFOUND)
    )
    for g, r in zip((found_h, slot_h, val_h), ref[1:]):
        assert np.array_equal(g.numpy()[0], np.asarray(r))
    if bsz > 2:  # the EMPTY lanes really did take a NULL child in JAX
        assert int(np.asarray(ref[0])[0]) in (-1, int(got[0][0, 0]))


def test_empty_query_reaches_scratch_through_null_child(grown):
    """Hazard pinned explicitly: an EMPTY query counts every router, takes
    child b-1, which is NULL in a non-full root, and is reported as leaf -1
    (as JAX reports it) while it reads the scratch row N-1."""
    t, _, st = grown
    root = int(st.root[0])
    if int(st.size[0, root]) == t.cfg.b:
        pytest.skip("root is full: child b-1 is a real node")
    leaf, found, slot, val = descend_probe(
        st.keys, st.vals, st.children, st.is_leaf, st.root,
        torch.tensor([[int(EMPTY)]]), max_height=t.cfg.max_height, notfound=int(NOTFOUND),
    )
    assert int(leaf[0, 0]) == -1 and bool(found[0, 0]) and int(slot[0, 0]) == 0


@pytest.mark.parametrize(
    "bsz,m,f,density",
    [(1, 72, 8, 0.1), (8, 72, 8, 0.5), (16, 288, 32, 0.2), (5, 1152, 128, 0.05),
     (4, 144, 16, 1.0), (4, 144, 16, 0.0), (33, 96, 8, 0.15),
     (3, 2400, 200, 0.08)],  # rows past a warp's reach on the card (f = 200)
)
def test_frontier_compact_plain_equals_jax(bsz, m, f, density):
    """The plain version (cumsum rank + scatter, finished with ``scratch``
    as the kernel finishes it), the public wrapper and the port's argsort
    oracle against the JAX argsort oracle and the interpreted Pallas kernel,
    including overflowing, all-valid and all-invalid rows."""
    rng = np.random.default_rng(int(m * f * (1 + density * 10)))
    cand = rng.integers(0, 4096, (bsz, m)).astype(np.int32)
    valid = rng.random((bsz, m)) < density
    jargs = (jnp.asarray(cand), jnp.asarray(valid))
    want = jfrontier_compact_ref(*jargs, f, scratch=4097)
    pallas = jfrontier_compact(*jargs, f, scratch=4097, use_pallas=True)
    targs = (torch.as_tensor(cand), torch.as_tensor(valid))
    plain = frontier_compact_plain(*targs, f, scratch=4097)
    got = frontier_compact(*targs, f, scratch=4097)
    oracle = frontier_compact_ref(*targs, f, scratch=4097)
    for pl, g, o, w, p, name in zip(plain, got, oracle, want, pallas,
                                    ("frontier", "valid", "overflow")):
        assert pl.dtype == g.dtype and pl.shape == g.shape, name
        assert np.array_equal(pl.numpy(), np.asarray(w)), f"plain vs ref {name}"
        assert np.array_equal(pl.numpy(), np.asarray(p)), f"plain vs pallas {name}"
        assert np.array_equal(g.numpy(), np.asarray(w)), f"ref {name}"
        assert np.array_equal(o.numpy(), np.asarray(w)), f"oracle {name}"
    assert plain[0].dtype == torch.int32 and plain[1].dtype == torch.bool
