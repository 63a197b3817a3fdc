"""The port's LM decode stack against the JAX package on the CPU.

Layer functions first (norms, rotary embedding, MLPs, embeddings), then
``forward_decode`` of ``reduced(qwen2-0.5b)`` (2 layers, f32) over 6 steps
with the JAX package's initialized params carried across by
``repro_torch.interop``: logits and caches within atol/rtol 1e-4 (f32
products summed in another order).  The configs, the param spec trees
(every arch's) and the dispatch on an unknown family are checked too."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import backbone as jbackbone  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models.config import reduced as jreduced  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.interop import cache_from_numpy, cache_to_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import backbone, layers, params as tparams  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg(**kw):
    return reduced(get_config("qwen2-0.5b"), **kw), jreduced(jget_config("qwen2-0.5b"), **kw)


def test_configs_equal_jax():
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget_config(arch)), arch
    t, j = _cfg()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def _spec_equal_jax(arch):
    ts = backbone.model_spec(get_config(arch))
    js = jbackbone.model_spec(jget_config(arch))
    flat_t = {p: (s.shape, s.axes, s.init, s.scale) for p, s in tparams._walk(ts)}
    flat_j = {p: (s.shape, s.axes, s.init, s.scale) for p, s in jparams._walk(js)}
    assert flat_t == flat_j, arch
    assert tparams.count_params(ts) == jparams.count_params(js)
    return tparams.count_params(ts)


@pytest.mark.parametrize("arch,n_params", [("xlstm-350m", 233_252_000),
                                           ("zamba2-1.2b", 1_178_862_464),
                                           ("whisper-tiny", 36_448_128)])
def test_ssm_hybrid_audio_spec_and_param_count_equal_jax(arch, n_params):
    """The families ported last: their spec trees (xLSTM's mblocks and
    sblocks, zamba2's mamba stack and shared block, whisper's encoder and
    decoder stacks) and their parameter counts equal JAX's."""
    assert _spec_equal_jax(arch) == n_params


def test_spec_tree_and_param_count_equal_jax():
    for arch in ("qwen2-0.5b", "h2o-danube-1.8b", "granite-moe-3b-a800m", "deepseek-v3-671b",
                 "internvl2-2b", "xlstm-350m", "zamba2-1.2b", "whisper-tiny"):
        _spec_equal_jax(arch)
    assert tparams.count_params(backbone.model_spec(get_config("qwen2-0.5b"))) == 494_032_768


@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_norm_equals_jax(norm):
    t, j = _cfg(norm=norm)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, t.d_model)).astype(np.float32)
    p = {"scale": rng.standard_normal(t.d_model).astype(np.float32),
         "bias": rng.standard_normal(t.d_model).astype(np.float32)}
    want = np.asarray(jlayers.norm_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), j))
    got = layers.norm_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), t)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_rope_equals_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 3, 32)).astype(np.float32)
    pos = np.array([[0, 7, 300], [5, 6, 1023]], np.int32)[:, None, :]
    assert np.array_equal(layers.rope_frequencies(32, 1e6), jlayers.rope_frequencies(32, 1e6))
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_equals_jax(act):
    t, j = _cfg(act=act)
    spec = layers.mlp_spec(t)
    rng = np.random.default_rng(3)
    p = {k: (rng.standard_normal(s.shape) * 0.1).astype(np.float32) for k, s in spec.items()}
    x = rng.standard_normal((2, 1, t.d_model)).astype(np.float32)
    want = np.asarray(jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), j))
    got = layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), t)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("tie", [True, False])
def test_embed_and_unembed_equal_jax(tie):
    t, j = _cfg(tie_embeddings=tie)
    jp = jparams.init_params(jlayers.embed_spec(j))
    tp = params_from_numpy(_np_tree(jp))
    tok = np.array([[0, 5, 511]], np.int32)
    e = layers.embed_apply(tp, torch.from_numpy(tok), t)
    np.testing.assert_array_equal(e.numpy(), np.asarray(jlayers.embed_apply(jp, jnp.asarray(tok), j)))
    x = np.random.default_rng(4).standard_normal((1, 3, t.d_model)).astype(np.float32)
    got = layers.unembed_apply(tp, torch.from_numpy(x), t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jlayers.unembed_apply(jp, jnp.asarray(x), j)), **TOL)


@pytest.fixture(scope="module")
def decode_run():
    """6 decode steps of reduced qwen2-0.5b (2 layers, f32) in both
    packages, from the JAX package's params and an empty cache."""
    t, j = _cfg()
    jp = jparams.init_params(jbackbone.model_spec(j))
    tp = params_from_numpy(_np_tree(jp))
    b, s_max = 3, 16
    jc = jbackbone.init_cache(j, b, s_max)
    tc = cache_from_numpy(_np_tree(jc))
    step = jax.jit(lambda p, c, tok, pos: jbackbone.forward_decode(p, c, tok, pos, j))
    rng = np.random.default_rng(7)
    out = []
    for pos in range(6):
        tok = rng.integers(0, t.vocab, b).astype(np.int32)
        jl, jc = step(jp, jc, jnp.asarray(tok), jnp.int32(pos))
        tl, tc = backbone.forward_decode(tp, tc, torch.from_numpy(tok), pos, t)
        out.append((np.asarray(jl), tl.numpy(), _np_tree(jc), cache_to_numpy(tc)))
    return out


@pytest.mark.parametrize("step", range(6))
def test_forward_decode_equals_jax(decode_run, step):
    jl, tl, jc, tc = decode_run[step]
    assert tl.shape == jl.shape and tl.dtype == np.float32
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(tc["layers"]["k"], np.asarray(jc["layers"].k), **TOL)
    np.testing.assert_allclose(tc["layers"]["v"], np.asarray(jc["layers"].v), **TOL)


def test_weights_cast_once_give_the_same_outputs():
    """``compute_params`` (each weight cast to bf16 once) and the fp32
    master weights cast at every use give bit-equal bf16 decode steps."""
    t = reduced(get_config("qwen2-0.5b"), dtype="bfloat16")
    master = tparams.init_params(backbone.model_spec(t), "cpu", seed=3)
    cast = backbone.compute_params(master, t)
    assert cast["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert cast["embed"]["tok"].dtype == torch.float32
    assert cast["layers"]["ln1"]["scale"].dtype == torch.float32
    c1, c2 = backbone.init_cache(t, 2, 8, "cpu"), backbone.init_cache(t, 2, 8, "cpu")
    for pos in range(3):
        tok = torch.tensor([pos, 7])
        a, c1 = backbone.forward_decode(master, c1, tok, pos, t)
        b, c2 = backbone.forward_decode(cast, c2, tok, pos, t)
        assert torch.equal(a, b) and torch.equal(c1["layers"].k, c2["layers"].k)


def test_init_is_seeded_per_leaf_path():
    t, _ = _cfg()
    spec = backbone.model_spec(t)
    a = tparams.init_params(spec, "cpu", seed=0)
    b = tparams.init_params(spec, "cpu", seed=0)
    c = tparams.init_params(spec, "cpu", seed=1)
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert not torch.equal(a["layers"]["attn"]["wq"], c["layers"]["attn"]["wq"])
    assert torch.equal(a["layers"]["attn"]["bq"], torch.zeros_like(a["layers"]["attn"]["bq"]))
    assert torch.equal(a["ln_f"]["scale"], torch.ones(t.d_model))


def test_unknown_family_raises_key_error():
    """Every family dispatches through a table, as JAX's does: a family
    with no entry raises ``KeyError`` on every path, as JAX's dict lookup
    does."""
    t, j = _cfg()
    for cfg, bb in ((t, backbone), (j, jbackbone)):
        odd = cfg.replace(family="tabular")
        with pytest.raises(KeyError, match="tabular"):
            bb.model_spec(odd)
        with pytest.raises(KeyError, match="tabular"):
            bb.cache_spec(odd, 1, 4)
    with pytest.raises(KeyError, match="tabular"):
        backbone.forward_train({}, torch.zeros((1, 2), dtype=torch.int64), t.replace(family="tabular"))
    with pytest.raises(KeyError, match="tabular"):
        backbone.forward_decode({}, {}, torch.zeros(1, dtype=torch.int64), 0,
                                t.replace(family="tabular"))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("tabular-1b")
