"""The port's xLSTM cells and the ssm family against the JAX package on the
CPU.

At ``reduced(xlstm-350m)`` (2 blocks: an mLSTM, then an sLSTM; d_model 128,
4 heads of 32; f32) with the same seeded numpy params in both packages
(``test_torch_moe.np_params``):

* the cells: ``mlstm_train``, ``slstm_train`` and three decode steps of
  each from an empty cache (outputs and every cache field), the chunked
  mLSTM against JAX's chunked form and against the step-by-step form, and
  the gradient of one weight through ``mlstm_train``: within atol / rtol
  1e-5 (f32 products summed in another order);
* the model (``family_run``, shared by the ssm, hybrid and audio files):
  ``forward_train`` logits within 1e-4, ``loss_fn`` within 1e-5 and every
  grad leaf by name within rtol 1e-4 / atol 1e-6, three ``forward_decode``
  steps with their caches carried through ``cache_from_numpy`` /
  ``cache_to_numpy`` within 1e-4; ``compute_params`` at bf16 giving
  bit-equal decode steps; the params crossing ``params_to_numpy`` leaf for
  leaf;
* a serial ``ServeEngine`` of two requests giving JAX's tokens.

Each JAX reference is computed once, in a module-scoped fixture.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 before any JAX input is built)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import backbone as jbackbone  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.models.config import reduced as jreduced  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    cache_from_numpy,
    cache_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.models import backbone, reduced, xlstm  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from test_torch_moe import _flat, _np_tree, np_params  # noqa: E402

ARCH = "xlstm-350m"
B, T = 2, 32  # T: a multiple of the reduced configs' ssm_chunk (16)
DECODE_STEPS = 3
CELL_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
ENGINE = dict(max_batch=2, s_max=64, n_pages=8)
ENGINE_REQUESTS = [(0, 9, 3), (1, 6, 4)]  # (rid, prompt length, new tokens)


def cfgs(arch, **kw):
    return reduced(get_config(arch), **kw), jreduced(jget_config(arch), **kw)


def batch_of(cfg, seed=0, b=B, t=T):
    """Seeded numpy tokens (and whisper's frames) of the data stream's shapes."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


def family_run(arch):
    """One arch's reduced model in both packages, from the same numpy params
    and batch: JAX's logits, loss, grads and DECODE_STEPS decode steps (one
    jitted call each), then the port's on the same inputs, its decode cache
    taken from JAX's empty one through ``cache_from_numpy`` and read back
    through ``cache_to_numpy`` after every step."""
    t, j = cfgs(arch)
    npp = np_params(jbackbone.model_spec(j))
    jp, tp = jax.tree.map(jnp.asarray, npp), params_from_numpy(npp)
    batch = batch_of(t)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    extra = {k: v for k, v in jbatch.items() if k != "tokens"} or None

    def loss_and_logits(p):
        loss, _ = jbackbone.loss_fn(p, jbatch, j)
        return loss, jbackbone.forward_train(p, jbatch["tokens"], j, extra)

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(loss_and_logits, has_aux=True))(jp)
    jcache = jbackbone.init_cache(j, B, ENGINE["s_max"])
    step = jax.jit(lambda p, c, tok, pos: jbackbone.forward_decode(p, c, tok, pos, j))
    tcache = cache_from_numpy(_np_tree(jcache))
    decode = []
    for pos in range(DECODE_STEPS):
        tok = batch["tokens"][:, pos]
        jl, jcache = step(jp, jcache, jnp.asarray(tok), jnp.int32(pos))
        tl, tcache = backbone.forward_decode(tp, tcache, torch.from_numpy(tok), pos, t)
        decode.append((np.asarray(jl), tl.numpy(), _np_tree(jcache), cache_to_numpy(tcache)))

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    live = tree_map(lambda x: x.detach().requires_grad_(), tp)
    tloss, _ = backbone.loss_fn(live, tbatch, t)
    tgrads = torch.autograd.grad(tloss, tree_leaves(live))
    it = iter(tgrads)
    tgrads = tree_map(lambda _: next(it), tp)
    with torch.no_grad():
        textra = {k: v for k, v in tbatch.items() if k != "tokens"} or None
        tlogits = backbone.forward_train(tp, tbatch["tokens"], t, textra)
    return {
        "cfgs": (t, j), "npp": npp, "tp": tp,
        "logits": (np.asarray(jlogits), tlogits.numpy()),
        "loss": (float(jloss), float(tloss.detach())),
        "grads": (_flat(_np_tree(jgrads)), _flat(tree_map(lambda g: g.numpy(), tgrads))),
        "decode": decode,
    }


def assert_cache_close(tc, jc, tol):
    """The port's cache (``cache_to_numpy``) against JAX's, entry by entry
    and field by field."""
    assert set(tc) == set(jc)
    for name, entry in jc.items():
        if not hasattr(entry, "_asdict"):
            np.testing.assert_allclose(tc[name], np.asarray(entry), **tol, err_msg=name)
            continue
        fields = entry._asdict()
        assert set(tc[name]) == set(fields), name
        for f, a in fields.items():
            assert tc[name][f].shape == a.shape and tc[name][f].dtype == a.dtype, (name, f)
            np.testing.assert_allclose(tc[name][f], a, **tol, err_msg=f"{name}.{f}")


def check_forward_train(run):
    jl, tl = run["logits"]
    assert tl.shape == jl.shape and tl.dtype == np.float32
    np.testing.assert_allclose(tl, jl, **LOGIT_TOL)


def check_loss_and_grads(run):
    np.testing.assert_allclose(run["loss"][1], run["loss"][0], **LOSS_TOL)
    jg, tg = run["grads"]
    assert set(tg) == set(jg)
    for name in jg:
        assert np.isfinite(tg[name]).all(), name
        np.testing.assert_allclose(tg[name], jg[name], **GRAD_TOL, err_msg=name)


def check_decode_step(run, step):
    jl, tl, jc, tc = run["decode"][step]
    assert tl.shape == jl.shape and tl.dtype == np.float32
    np.testing.assert_allclose(tl, jl, **LOGIT_TOL)
    assert_cache_close(tc, jc, LOGIT_TOL)


def check_compute_params(arch):
    """bf16 decode steps from ``compute_params`` (each weight cast once)
    bit-equal to those from the fp32 master weights cast at every use."""
    t = reduced(get_config(arch), dtype="bfloat16")
    master = init_params(backbone.model_spec(t), "cpu", seed=3)
    cast = backbone.compute_params(master, t)
    c1, c2 = backbone.init_cache(t, 2, 8, "cpu"), backbone.init_cache(t, 2, 8, "cpu")
    for pos in range(3):
        tok = torch.tensor([pos, 7])
        a, c1 = backbone.forward_decode(master, c1, tok, pos, t)
        b, c2 = backbone.forward_decode(cast, c2, tok, pos, t)
        assert torch.equal(a, b), pos
        for x, y in zip(tree_leaves(cache_to_numpy(c1)), tree_leaves(cache_to_numpy(c2))):
            if x is not None:
                assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), pos
    return master, cast


def check_params_cross(run):
    """Params cross both ways unchanged, leaf for leaf under the same names."""
    back = _flat(params_to_numpy(run["tp"]))
    want = _flat(run["npp"])
    assert set(back) == set(want)
    for name, a in want.items():
        assert back[name].dtype == a.dtype and np.array_equal(back[name], a), name


def engine_tokens(arch):
    """A serial engine of ENGINE_REQUESTS on the reduced config in both
    packages, the port carrying the JAX engine's params: (JAX's tokens,
    the port's)."""
    t, j = cfgs(arch)
    rng = np.random.default_rng(11)
    reqs = [(rid, rng.integers(0, t.vocab, n).tolist(), new) for rid, n, new in ENGINE_REQUESTS]
    jeng = jengine.ServeEngine(j, **ENGINE)
    teng = ServeEngine(t, device="cpu", params=params_from_numpy(_np_tree(jeng.params)), **ENGINE)
    for eng, req in ((jeng, jengine.Request), (teng, Request)):
        for rid, prompt, new in reqs:
            eng.submit(req(rid=rid, prompt=prompt, max_new=new))
        eng.run_until_done(max_ticks=100)
    return ({r.rid: r.out for r in jeng.done}, {r.rid: r.out for r in teng.done})


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------


def _cell_params(spec, seed):
    """One cell's seeded numpy params from the JAX spec (biases non-zero)."""
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s.shape) * (0.3 if s.init != "normal" else 0.05))
            .astype(np.float32) for k, s in spec.items()}


@pytest.fixture(scope="module")
def cells():
    t, j = cfgs(ARCH)
    mp = _cell_params(jxlstm.mlstm_spec(j), 1)
    sp = _cell_params(jxlstm.slstm_spec(j), 2)
    x = np.random.default_rng(3).standard_normal((B, T, t.d_model)).astype(np.float32)
    w = np.random.default_rng(4).standard_normal((B, T, t.d_model)).astype(np.float32)
    jm, js = jax.tree.map(jnp.asarray, mp), jax.tree.map(jnp.asarray, sp)

    @jax.jit
    def ref(jm, js, x, w):
        out = {
            "mlstm": jxlstm.mlstm_train(jm, x, j),
            "chunked": jxlstm.mlstm_train_chunked(jm, x, j, chunk=16),
            "slstm": jxlstm.slstm_train(js, x, j),
            "grad_wq": jax.grad(lambda p: jnp.sum(jxlstm.mlstm_train(p, x, j) * w))(jm)["wq"],
        }
        # from the empty caches that init_cache gives (every field zero)
        mc = jax.tree.map(jnp.zeros_like, jxlstm.mlstm_cache_spec(j, B))
        sc = jax.tree.map(jnp.zeros_like, jxlstm.slstm_cache_spec(j, B))
        for i in range(DECODE_STEPS):
            ym, mc = jxlstm.mlstm_decode(jm, x[:, i:i + 1], j, mc)
            ys, sc = jxlstm.slstm_decode(js, x[:, i:i + 1], j, sc)
            out[f"mdec{i}"], out[f"sdec{i}"] = (ym, mc), (ys, sc)
        return out

    want = _np_tree(ref(jm, js, jnp.asarray(x), jnp.asarray(w)))
    return t, params_from_numpy(mp), params_from_numpy(sp), x, w, want


def test_mlstm_train_equals_jax(cells):
    t, mp, _, x, _, want = cells
    got = xlstm.mlstm_train(mp, torch.from_numpy(x), t)
    np.testing.assert_allclose(got.numpy(), want["mlstm"], **CELL_TOL)


def test_slstm_train_equals_jax(cells):
    t, _, sp, x, _, want = cells
    got = xlstm.slstm_train(sp, torch.from_numpy(x), t)
    np.testing.assert_allclose(got.numpy(), want["slstm"], **CELL_TOL)


def test_mlstm_chunked_equals_jax_and_the_sequential_form(cells):
    t, mp, _, x, _, want = cells
    got = xlstm.mlstm_train_chunked(mp, torch.from_numpy(x), t, chunk=16).numpy()
    np.testing.assert_allclose(got, want["chunked"], **CELL_TOL)
    np.testing.assert_allclose(got, want["mlstm"], **CELL_TOL)
    seq = xlstm.mlstm_train(mp, torch.from_numpy(x), t).numpy()
    np.testing.assert_allclose(got, seq, **CELL_TOL)


def test_mlstm_gradient_leaf_equals_jax(cells):
    t, mp, _, x, w, want = cells
    live = {k: v.clone().requires_grad_(k == "wq") for k, v in mp.items()}
    (xlstm.mlstm_train(live, torch.from_numpy(x), t) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(live["wq"].grad.numpy(), want["grad_wq"], **CELL_TOL)


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_cell_decode_steps_equal_jax(cells, cell):
    t, mp, sp, x, _, want = cells
    p, fn, spec = ((mp, xlstm.mlstm_decode, xlstm.mlstm_cache_spec) if cell == "mlstm"
                   else (sp, xlstm.slstm_decode, xlstm.slstm_cache_spec))
    cache = type(spec(t, B))(*(torch.zeros(s.shape, dtype=s.dtype) for s in spec(t, B)))
    for i in range(DECODE_STEPS):
        y, cache = fn(p, torch.from_numpy(x[:, i:i + 1]), t, cache)
        wy, wc = want[f"{cell[0]}dec{i}"]
        np.testing.assert_allclose(y.numpy(), wy, **CELL_TOL)
        assert type(cache)._fields == wc._fields
        for f, a in zip(cache, wc):
            np.testing.assert_allclose(f.numpy(), a, **CELL_TOL)


# ---------------------------------------------------------------------------
# the ssm family
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def run():
    return family_run(ARCH)


def test_forward_train_equals_jax(run):
    check_forward_train(run)


def test_loss_and_grads_equal_jax(run):
    check_loss_and_grads(run)


@pytest.mark.parametrize("step", range(DECODE_STEPS))
def test_forward_decode_equals_jax(run, step):
    check_decode_step(run, step)


def test_params_cross_unchanged(run):
    check_params_cross(run)


def test_compute_params_give_the_same_outputs():
    master, cast = check_compute_params(ARCH)
    m, s = cast["mblocks"]["cell"], cast["sblocks"]["cell"]
    assert {k for k, v in m.items() if v.dtype == torch.float32} == {"wi", "wf", "bi", "bf"}
    assert {k for k, v in s.items() if v.dtype == torch.float32} == {"wx", "wr", "b"}
    assert cast["mblocks"]["ln"]["scale"].dtype == torch.float32


def test_engine_tokens_equal_jax():
    want, got = engine_tokens(ARCH)
    assert got == want and len(got) == len(ENGINE_REQUESTS)
