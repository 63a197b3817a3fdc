"""The port's MoE FFN and the MoE LM against the JAX package on the CPU.

At ``reduced(granite-moe-3b-a800m)`` (2 layers, 8 experts top-2, f32) with
the JAX package's params carried across by ``repro_torch.interop``:

* the dispatch decisions, given the same router logits (JAX's, recorded
  while its ``_dispatch_ffn`` runs eagerly): chosen experts, the stable
  sort by expert, ranks, kept pairs and slots bit-equal, globally and with
  ``moe_groups=4`` (capacity per group), and at a capacity factor of 0.5
  that drops pairs globally; the router logits, routing weights
  and the layer's output within 1e-6 / rtol 1e-5 (f32 products summed in
  another order);
* ``aux_load_balance_loss`` within 1e-6;
* ``forward_train`` logits within 1e-4, ``loss_fn`` within 1e-5 and every
  grad leaf by name within rtol 1e-4 / atol 1e-6; ``forward_decode`` over 6
  steps, logits and caches within 1e-4;
* ``remat="dots"`` equal to ``"none"`` (loss and grads, bit for bit: the
  recomputation repeats the same arithmetic);
* an MoE checkpoint (the ``(L, E, d, f)`` expert leaves, the router) in
  both directions, leaves bit-equal under the same names.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 before any JAX input is built)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.checkpoint import restore as jrestore  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import backbone as jbackbone  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models.config import reduced as jreduced  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch.checkpoint import CheckpointManager, restore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    cache_from_numpy,
    cache_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.models import backbone, moe, reduced  # noqa: E402
from repro_torch.models.params import _walk  # noqa: E402
from repro_torch.optim import adamw_init, constant_lr  # noqa: E402
from repro_torch.optim.adamw import tree_map  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

ARCH = "granite-moe-3b-a800m"
B, S = 2, 24
LAYER_TOL = dict(atol=1e-6, rtol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {n: x for k, v in tree.items() for n, x in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _cfgs(**kw):
    return reduced(get_config(ARCH), **kw), jreduced(jget_config(ARCH), **kw)


def np_params(spec_tree, seed: int = 0):
    """Seeded numpy params for a JAX spec tree (its init kinds and scales),
    drawn in the tree's order: the same arrays go to both packages."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if s.init in ("zeros", "ones"):
            return np.full(s.shape, float(s.init == "ones"), np.float32)
        scale = 1.0 / np.sqrt(s.shape[-1]) if s.init == "embed" else s.scale
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jparams.map_specs(leaf, spec_tree)


def both_params(j, seed: int = 0):
    """(JAX params, port params) from the same seeded numpy arrays."""
    npp = np_params(jbackbone.model_spec(j), seed)
    return jax.tree.map(jnp.asarray, npp), params_from_numpy(npp)


@pytest.fixture(scope="module")
def model():
    t, j = _cfgs()
    return (t, j) + both_params(j)


def _layer_inputs(t, jp):
    """Layer 0's FFN params of both packages and seeded (B, S, d) inputs."""
    jffn = jax.tree.map(lambda a: a[0], jp["layers"]["ffn"])
    x = np.random.default_rng(1).standard_normal((B, S, t.d_model)).astype(np.float32)
    return jffn, params_from_numpy(_np_tree(jffn)), x


class _Spy:
    """A module stand-in: ``over``'s attributes, the rest from ``mod``."""

    def __init__(self, mod, **over):
        self._mod = mod
        self.__dict__.update(over)

    def __getattr__(self, name):
        return getattr(self._mod, name)


def _jax_dispatch(monkeypatch, jffn, xf, j, cap):
    """JAX's ``_dispatch_ffn`` run eagerly on one group, with its router
    logits, top-k, stable sort, first indices and slots recorded."""
    rec = {}

    def einsum(spec, *ops):
        out = jnp.einsum(spec, *ops)
        if spec == "td,de->te":
            rec["logits"] = np.asarray(out)
        return out

    def top_k(x, k):
        w, i = jax.lax.top_k(x, k)
        rec["topw"], rec["topi"] = np.asarray(w), np.asarray(i)
        return w, i

    def argsort(x, **kw):
        out = jnp.argsort(x, **kw)
        rec["order"] = np.asarray(out)
        return out

    def searchsorted(a, v, **kw):
        out = jnp.searchsorted(a, v, **kw)
        rec["first"] = np.asarray(out)
        return out

    def where(*a):
        out = jnp.where(*a)
        rec.setdefault("slot", np.asarray(out))  # the first where is the slot's
        return out

    monkeypatch.setattr(jmoe, "jnp", _Spy(jnp, einsum=einsum, argsort=argsort,
                                          searchsorted=searchsorted, where=where))
    monkeypatch.setattr(jmoe, "jax", _Spy(jax, lax=_Spy(jax.lax, top_k=top_k)))
    y = jmoe._dispatch_ffn(jffn, jnp.asarray(xf), j, cap)
    monkeypatch.undo()
    return rec, np.asarray(y)


@pytest.mark.parametrize("groups, cf, want_g, want_cap, drops", [
    (0, 1.25, 1, 15, False), (0, 0.5, 1, 6, True), (4, 1.25, 4, 4, True),
], ids=["global", "global-cf0.5", "groups4"])
def test_dispatch_is_bit_equal_given_the_same_router_logits(model, monkeypatch, groups, cf,
                                                            want_g, want_cap, drops):
    t, j, jp, _ = model
    t = t.replace(moe_groups=groups, capacity_factor=cf)
    j = j.replace(moe_groups=groups, capacity_factor=cf)
    jffn, tffn, x = _layer_inputs(t, jp)
    g, cap = moe.capacity(t, B * S)
    assert (g, cap) == (want_g, want_cap)  # host ints from shapes
    xg = x.reshape(g, B * S // g, t.d_model)
    recs = [_jax_dispatch(monkeypatch, jffn, xg[i], j, cap)[0] for i in range(g)]
    logits = torch.from_numpy(np.stack([r["logits"] for r in recs]))
    np.testing.assert_allclose(moe.router_logits(tffn["router"], torch.from_numpy(xg)).numpy(),
                               logits.numpy(), **LAYER_TOL)
    r = moe.route(logits, t.top_k, cap)
    e = t.n_experts
    for i, rec in enumerate(recs):
        order = rec["order"]
        eid_s = rec["topi"].reshape(-1)[order]
        np.testing.assert_array_equal(r.topi[i].numpy(), rec["topi"])
        np.testing.assert_array_equal(r.order[i].numpy(), order)
        np.testing.assert_array_equal(r.eid_s[i].numpy(), eid_s)
        np.testing.assert_array_equal(r.tok_s[i].numpy(), np.repeat(np.arange(B * S // g), t.top_k)[order])
        np.testing.assert_array_equal(r.rank[i].numpy(), np.arange(order.size) - rec["first"][eid_s])
        np.testing.assert_array_equal(r.slot[i].numpy(), rec["slot"])
        np.testing.assert_array_equal(r.ok[i].numpy(), rec["slot"] != e * cap)
        np.testing.assert_allclose(r.topw[i].numpy(), rec["topw"] / rec["topw"].sum(-1, keepdims=True),
                                   **LAYER_TOL)
    assert bool((~r.ok).any()) == drops  # the capacity path, where the case drops pairs

    # the layer with JAX's logits, and with its own, against JAX's layer
    want = np.asarray(jmoe.moe_apply(jffn, jnp.asarray(x), j))
    got = moe.moe_apply(tffn, torch.from_numpy(x), t).numpy()
    np.testing.assert_allclose(got, want, **LAYER_TOL)
    monkeypatch.setattr(moe, "router_logits", lambda router, xg: logits)
    got_same = moe.moe_apply(tffn, torch.from_numpy(x), t).numpy()
    np.testing.assert_allclose(got_same, want, **LAYER_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scatter_back_adds_in_jax_order(model, dtype):
    """The token sum equals a scatter-add over the sorted pairs one pair at a
    time (JAX's sequential scatter order), bit for bit, in bf16 where every
    add rounds; and it is the same on a second call."""
    t, _, _, _ = model
    g, cap = 2, 5
    k, e, n = t.top_k, t.n_experts, 12
    rng = np.random.default_rng(3)
    r = moe.route(torch.from_numpy(rng.standard_normal((g, n, e)).astype(np.float32)), k, cap)
    ye = torch.from_numpy(rng.standard_normal((g, e * cap, 16)).astype(np.float32)).to(dtype)
    got = moe.scatter_back(ye, r, n)
    want = torch.zeros((g, n, 16), dtype=dtype)
    for gi in range(g):
        for i in range(n * k):
            s = min(int(r.slot[gi, i]), e * cap - 1)
            w = float(r.w_s[gi, i]) if bool(r.ok[gi, i]) else 0.0
            c = ye[gi, s] * torch.tensor(w, dtype=torch.float32).to(dtype)
            want[gi, int(r.tok_s[gi, i])] += c
    assert not r.ok.all()
    assert torch.equal(got, want)
    assert torch.equal(moe.scatter_back(ye, r, n), got)


def test_aux_load_balance_loss_equals_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((37, 8)).astype(np.float32)
    topi = np.argsort(-logits, axis=-1)[:, :2].astype(np.int32)
    want = float(jmoe.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(topi), 8))
    got = moe.aux_load_balance_loss(torch.from_numpy(logits), torch.from_numpy(topi), 8)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def run(model):
    """Both packages' forward, loss and grads on the same params and tokens."""
    t, j, jp, tp = model
    tokens = np.random.default_rng(0).integers(0, t.vocab, (B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens)}
    jlogits = jax.jit(lambda p: jbackbone.forward_train(p, jb["tokens"], j))(jp)
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p: jbackbone.loss_fn(p, jb, j),
                                             has_aux=True))(jp)
    live = tree_map(lambda x: x.detach().clone().requires_grad_(), tp)
    tl, _ = backbone.loss_fn(live, {"tokens": torch.from_numpy(tokens)}, t)
    tl.backward()
    return dict(tokens=tokens, jlogits=np.asarray(jlogits), jl=float(jl), tl=float(tl.detach()),
                tlogits=backbone.forward_train(tp, torch.from_numpy(tokens), t).numpy(),
                jg=_flat(_np_tree(jg)), tg={n: x.grad.numpy() for n, x in _flat(live).items()})


LEAVES = sorted(p[1:] for p, _ in _walk(backbone.model_spec(reduced(get_config(ARCH)))))


def test_forward_and_loss_equal_jax(run):
    assert run["tlogits"].shape == run["jlogits"].shape and run["tlogits"].dtype == np.float32
    np.testing.assert_allclose(run["tlogits"], run["jlogits"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(run["tl"], run["jl"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("leaf", LEAVES)
def test_grad_leaf_equals_jax(run, leaf):
    assert set(run["tg"]) == set(run["jg"]) == set(LEAVES)
    np.testing.assert_allclose(run["tg"][leaf], run["jg"][leaf], rtol=1e-4, atol=1e-6)


def test_forward_decode_equals_jax(model):
    """6 decode steps from an empty cache: logits and caches within 1e-4."""
    t, j, jp, tp = model
    b, s_max = 3, 16
    jc = jbackbone.init_cache(j, b, s_max)
    tc = cache_from_numpy(_np_tree(jc))
    step = jax.jit(lambda p, c, tok, pos: jbackbone.forward_decode(p, c, tok, pos, j))
    rng = np.random.default_rng(7)
    for pos in range(6):
        tok = rng.integers(0, t.vocab, b).astype(np.int32)
        jl, jc = step(jp, jc, jnp.asarray(tok), jnp.int32(pos))
        tl, tc = backbone.forward_decode(tp, tc, torch.from_numpy(tok), pos, t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        got = cache_to_numpy(tc)["layers"]
        np.testing.assert_allclose(got["k"], np.asarray(jc["layers"].k), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got["v"], np.asarray(jc["layers"].v), atol=1e-4, rtol=1e-4)


def test_remat_dots_equals_none(model, run):
    """One train step under remat="dots" (2-D products kept, the batched
    expert and attention products recomputed) gives the loss and params of
    remat="none" bit for bit."""
    t, _, _, tp = model
    tb = {"tokens": torch.from_numpy(run["tokens"])}
    outs = [make_train_step(cfg, schedule=constant_lr)(tp, adamw_init(tp), tb, 0)
            for cfg in (t, t.replace(remat="dots"))]
    assert torch.equal(outs[0].metrics["loss"], outs[1].metrics["loss"])
    assert torch.equal(outs[0].metrics["grad_norm"], outs[1].metrics["grad_norm"])
    for a, b in zip(_flat(outs[0].params).values(), _flat(outs[1].params).values()):
        assert torch.equal(a, b)


def _index(directory, step):
    with open(f"{directory}/step_{step:08d}/index.json") as f:
        return json.load(f)["index"]


def test_moe_checkpoint_crosses_both_ways(model, tmp_path):
    """A JAX (params, OptState) of the MoE arch saved by the port restores
    in JAX, and one saved by JAX restores in the port: same leaf names,
    bit-equal leaves, the (L, E, d, f) expert stacks included."""
    t, _, jp, tp = model
    jp1 = jax.tree.map(lambda a: a + 1e-3, jp)
    jopt = jadamw.OptState(m=jax.tree.map(lambda a: a * 0.5, jp), v=jax.tree.map(jnp.square, jp),
                           count=jnp.asarray(3, jnp.int32))
    assert jp1["layers"]["ffn"]["wi"].shape == (t.n_layers, t.n_experts, t.d_model, t.d_ff_expert)
    from repro_torch.interop import opt_state_from_numpy, opt_state_to_numpy

    state = {"params": params_from_numpy(_np_tree(jp1)), "opt": opt_state_from_numpy(_np_tree(jopt))}
    CheckpointManager(str(tmp_path / "t")).save(5, state, extra={"step": 5})
    JCheckpointManager(str(tmp_path / "j")).save(5, {"params": jp1, "opt": jopt}, extra={"step": 5})
    assert _index(tmp_path / "t", 5) == _index(tmp_path / "j", 5)
    assert "params.layers.ffn.router" in _index(tmp_path / "t", 5)
    got_j = jrestore(str(tmp_path / "t"), 5, {"params": jp, "opt": jadamw.adamw_init(jp)})
    for a, b in zip(jax.tree.leaves(got_j), jax.tree.leaves({"params": jp1, "opt": jopt})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got_t = restore(str(tmp_path / "j"), 5, {"params": tp, "opt": adamw_init(tp)}, device="cpu")
    want = _flat(_np_tree(jp1))
    for n, x in _flat(params_to_numpy(got_t["params"])).items():
        assert x.dtype == want[n].dtype
        np.testing.assert_array_equal(x, want[n])
    m = _flat(opt_state_to_numpy(got_t["opt"])["m"])
    for n, x in _flat(_np_tree(jopt.m)).items():
        np.testing.assert_array_equal(m[n], x)
