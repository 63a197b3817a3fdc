"""The port's MLA attention, the MoE + MLA LM (deepseek-v3) and the VLM
(internvl2) against the JAX package on the CPU.

At ``reduced(deepseek-v3-671b)`` (2 layers, one dense and one MoE with the
shared expert, MLA with q_lora 64, kv_lora 32, rope head 16, f32) and
``reduced(internvl2-2b)`` (8 patch embeddings a row), both packages given
the same seeded numpy params:

* ``mla_train`` within 1e-6 / rtol 1e-5; ``mla_decode`` over 6 steps, its
  output and latent cache within the same (f32 products summed in another
  order);
* ``forward_train`` logits within 1e-4, ``loss_fn`` within 1e-5 and every
  grad leaf by name within rtol 1e-4 / atol 1e-6, the VLM's with
  ``vis_embeds`` (the text positions' logits only);
* ``forward_decode`` of deepseek over 6 steps: logits and both stacks'
  latent caches (``dense_layers``, ``layers``) within 1e-4, and the caches
  cross ``repro_torch.interop`` with ``v=None`` both ways.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 before any JAX input is built)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import backbone as jbackbone  # noqa: E402
from repro.models.config import reduced as jreduced  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import cache_from_numpy, cache_to_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import attention, backbone, reduced  # noqa: E402
from repro_torch.models.params import _walk  # noqa: E402
from repro_torch.optim.adamw import tree_map  # noqa: E402
from test_torch_moe import both_params, np_params  # noqa: E402

B, S = 2, 24
LAYER_TOL = dict(atol=1e-6, rtol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {n: x for k, v in tree.items() for n, x in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _cfgs(arch):
    return reduced(get_config(arch)), jreduced(jget_config(arch))


@pytest.fixture(scope="module")
def mla_layer():
    t, j = _cfgs("deepseek-v3-671b")
    npp = np_params(jattn.mla_spec(j), seed=4)
    return t, j, jax.tree.map(jnp.asarray, npp), params_from_numpy(npp)


def test_mla_spec_and_train_equal_jax(mla_layer):
    t, j, jp, tp = mla_layer
    assert {k: s.shape for k, s in attention.mla_spec(t).items()} == \
        {k: s.shape for k, s in jattn.mla_spec(j).items()}
    x = np.random.default_rng(5).standard_normal((B, S, t.d_model)).astype(np.float32)
    want = np.asarray(jattn.mla_train(jp, jnp.asarray(x), j))
    got = attention.mla_train(tp, torch.from_numpy(x), t)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)


def test_mla_decode_equals_jax(mla_layer):
    t, j, jp, tp = mla_layer
    b, s_max = 3, 8
    spec = jattn.mla_cache_spec(j, b, s_max)
    assert spec.v is None and attention.mla_cache_spec(t, b, s_max).v is None
    jc = jattn.KVCache(jnp.zeros(spec.k.shape, spec.k.dtype), None)
    tc = attention.KVCache(torch.zeros(spec.k.shape), None)
    rng = np.random.default_rng(6)
    step = jax.jit(lambda c, x, pos: jattn.mla_decode(jp, x, j, c, pos))
    for pos in range(6):
        x = rng.standard_normal((b, 1, t.d_model)).astype(np.float32)
        jy, jc = step(jc, jnp.asarray(x), jnp.int32(pos))
        ty, tc = attention.mla_decode(tp, torch.from_numpy(x), t, tc, pos)
        assert tc.v is None
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **LAYER_TOL)


def _batch(t, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, t.vocab, (B, S)).astype(np.int32)}
    if t.family == "vlm":
        batch["vis_embeds"] = rng.standard_normal((B, t.vis_tokens, t.d_model)).astype(np.float32)
    return batch


def _run(arch):
    t, j = _cfgs(arch)
    jp, tp = both_params(j, seed=1)
    batch = _batch(t)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    extra = {k: v for k, v in jb.items() if k != "tokens"} or None
    jlogits = jax.jit(lambda p: jbackbone.forward_train(p, jb["tokens"], j, extra))(jp)
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p: jbackbone.loss_fn(p, jb, j),
                                             has_aux=True))(jp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_extra = {k: v for k, v in tb.items() if k != "tokens"} or None
    tlogits = backbone.forward_train(tp, tb["tokens"], t, t_extra)
    live = tree_map(lambda x: x.detach().clone().requires_grad_(), tp)
    tl, _ = backbone.loss_fn(live, tb, t)
    tl.backward()
    return dict(t=t, j=j, jp=jp, tp=tp, jlogits=np.asarray(jlogits), tlogits=tlogits.numpy(),
                jl=float(jl), tl=float(tl.detach()), jg=_flat(_np_tree(jg)),
                tg={n: x.grad.numpy() for n, x in _flat(live).items()})


@pytest.fixture(scope="module")
def deepseek():
    return _run("deepseek-v3-671b")


@pytest.fixture(scope="module")
def internvl2():
    return _run("internvl2-2b")


def test_deepseek_spec_has_both_stacks(deepseek):
    t, j = deepseek["t"], deepseek["j"]
    assert t.first_k_dense == 1 and t.n_shared == 1 and t.attn == "mla" and t.remat == "dots"
    spec = backbone.model_spec(t)
    assert spec["dense_layers"]["ffn"]["wi"].shape == (1, t.d_model, t.d_ff)
    assert spec["layers"]["ffn"]["wi"].shape == (1, t.n_experts, t.d_model, t.d_ff_expert)
    assert spec["layers"]["ffn"]["shared"]["wi"].shape == (1, t.d_model, t.d_ff_expert)


@pytest.mark.parametrize("which", ["deepseek", "internvl2"])
def test_forward_and_loss_equal_jax(request, which):
    run = request.getfixturevalue(which)
    assert run["tlogits"].shape == run["jlogits"].shape == (B, S, run["t"].vocab)
    np.testing.assert_allclose(run["tlogits"], run["jlogits"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(run["tl"], run["jl"], atol=1e-5, rtol=1e-5)


def _leaves(arch):
    return sorted(p[1:] for p, _ in _walk(backbone.model_spec(reduced(get_config(arch)))))


@pytest.mark.parametrize("leaf", _leaves("deepseek-v3-671b"))
def test_deepseek_grad_leaf_equals_jax(deepseek, leaf):
    assert set(deepseek["tg"]) == set(deepseek["jg"])
    np.testing.assert_allclose(deepseek["tg"][leaf], deepseek["jg"][leaf], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("leaf", _leaves("internvl2-2b"))
def test_internvl2_grad_leaf_equals_jax(internvl2, leaf):
    assert set(internvl2["tg"]) == set(internvl2["jg"])
    np.testing.assert_allclose(internvl2["tg"][leaf], internvl2["jg"][leaf], rtol=1e-4, atol=1e-6)


def test_deepseek_forward_decode_and_latent_caches_equal_jax(deepseek):
    t, j, jp, tp = deepseek["t"], deepseek["j"], deepseek["jp"], deepseek["tp"]
    b, s_max = 3, 16
    jc = jbackbone.init_cache(j, b, s_max)
    tc = cache_from_numpy(_np_tree(jc))
    assert set(tc) == {"dense_layers", "layers"} and tc["layers"].v is None
    assert tc["layers"].k.shape == (1, b, s_max, t.kv_lora + t.rope_head)
    fresh = backbone.init_cache(t, b, s_max, "cpu")
    assert fresh["dense_layers"].v is None and torch.equal(fresh["layers"].k, tc["layers"].k)
    step = jax.jit(lambda p, c, tok, pos: jbackbone.forward_decode(p, c, tok, pos, j))
    rng = np.random.default_rng(7)
    for pos in range(6):
        tok = rng.integers(0, t.vocab, b).astype(np.int32)
        jl, jc = step(jp, jc, jnp.asarray(tok), jnp.int32(pos))
        tl, tc = backbone.forward_decode(tp, tc, torch.from_numpy(tok), pos, t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        got = cache_to_numpy(tc)
        for name in ("dense_layers", "layers"):
            assert got[name]["v"] is None and jc[name].v is None
            np.testing.assert_allclose(got[name]["k"], np.asarray(jc[name].k), atol=1e-4, rtol=1e-4)
