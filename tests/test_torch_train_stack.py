"""The rest of the port's training stack against the JAX package on the CPU.

* ``embed_elim_update`` / ``embed_occ_update`` (``optim/sparse.py``): the
  statistics exactly (int32), the tables within 1e-6 of JAX's and of each
  other (f32 sums in another order), and within each row's
  summation-order bound of a float64 sum of the same updates;
* ``quantize_int8`` / ``dequantize_int8`` / ``_ef_quantize``
  (``parallel/compress.py``): payloads, scales, dequantized values and
  error-feedback residuals bit-equal to JAX's, ties at .5 included;
* ``DedupIndex`` (``data/dedup.py``): hashes, keep lists, stats and the
  final tree state bit-equal to JAX's in both modes;
* the train step that donates its params and optimizer state equal bit for
  bit to the one that does not (which leaves its inputs as they were), on
  the MoE arch's stacked expert leaves, and AdamW's pass over runs of
  layers equal to one pass a leaf;
* ``ServeEngine`` on a tiny MoE + MLA config (a dense first layer, the
  shared expert, a latent cache) giving the JAX engine's tokens, and the
  launchers on the new archs.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 before any JAX input is built)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import dedup as jdedup  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.optim import sparse as jsparse  # noqa: E402
from repro.parallel import compress as jcompress  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DedupIndex, content_hash  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import backbone, init_params, reduced  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.optim import adamw_init, constant_lr, embed_elim_update  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim.sparse import SparseUpdateStats, embed_occ_update  # noqa: E402
from repro_torch.parallel import compress  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from test_torch_moe import np_params  # noqa: E402
from test_torch_rounds import _pool_diff  # noqa: E402


# ---------------------------------------------------------------------------
# EmbedElim
# ---------------------------------------------------------------------------


def _sparse_inputs(v=64, d=8, t=300, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    ids = (np.minimum(rng.zipf(1.5, t), v) - 1).astype(np.int32)
    grads = rng.standard_normal((t, d)).astype(np.float32)
    return table, ids, grads


def _bound(table, ids, grads, lr):
    """Each entry's summation-order bound: (count + 1) · 2^-24 · (the row's
    sum of |lr·g| + |table|), in float64: every add of either version
    rounds against at most that magnitude."""
    count = np.bincount(ids, minlength=table.shape[0])[:, None].astype(np.float64)
    mag = np.zeros(table.shape, np.float64)
    np.add.at(mag, ids, np.abs(float(np.float32(lr)) * grads.astype(np.float64)))
    return (count + 1) * 2.0**-24 * (mag + np.abs(table.astype(np.float64)))


@pytest.mark.parametrize("seed", [0, 1])
def test_embed_updates_equal_jax(seed):
    table, ids, grads = _sparse_inputs(seed=seed)
    lr = 0.1
    jnew, jstats = jsparse.embed_elim_update(jnp.asarray(table), jnp.asarray(ids),
                                             jnp.asarray(grads), lr)
    jocc = jsparse.embed_occ_update(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(grads), lr)
    tnew, tstats = embed_elim_update(torch.from_numpy(table), torch.from_numpy(ids),
                                     torch.from_numpy(grads), lr)
    tocc = embed_occ_update(torch.from_numpy(table), torch.from_numpy(ids),
                            torch.from_numpy(grads), lr)
    assert isinstance(tstats, SparseUpdateStats)
    for got, want in zip(tstats, jstats):
        assert got.dtype == torch.int32 and int(got) == int(want)
    n_unique = len(set(ids.tolist()))
    assert int(tstats.writes_elim) == n_unique and int(tstats.eliminated) == ids.size - n_unique > 0
    assert tnew.shape == table.shape and tnew.dtype == torch.float32
    np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tocc.numpy(), np.asarray(jocc), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tnew.numpy(), tocc.numpy(), atol=1e-6, rtol=1e-6)
    want64 = table.astype(np.float64)  # at the rate the f32 products see
    np.add.at(want64, ids, -float(np.float32(lr)) * grads.astype(np.float64))
    bound = _bound(table, ids, grads, lr)
    for got in (tnew, tocc):
        assert np.all(np.abs(got.numpy() - want64) <= bound)
    assert torch.equal(torch.from_numpy(table), torch.from_numpy(_sparse_inputs(seed=seed)[0]))


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------


def _compress_cases():
    rng = np.random.default_rng(4)
    ties = np.zeros(256, np.float32)
    ties[:6] = [127.0, 0.5, 1.5, 2.5, -0.5, -3.5]  # scale 1: q rounds half to even
    return {
        "777": (rng.standard_normal(777) * 0.01).astype(np.float32),
        "block": rng.standard_normal((4, 64)).astype(np.float32),
        "3x300": (rng.standard_normal((3, 300)) * 5).astype(np.float32),
        "zeros": np.zeros(300, np.float32),
        "ties": ties,
    }


@pytest.mark.parametrize("case", sorted(_compress_cases()))
def test_quantize_dequantize_bit_equal_jax(case):
    x = _compress_cases()[case]
    jq, js = jcompress.quantize_int8(jnp.asarray(x))
    q, s = compress.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    jy = jcompress.dequantize_int8(jq, js, x.shape, jnp.float32)
    y = compress.dequantize_int8(q, s, x.shape, torch.float32)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    err = float(np.max(np.abs(y.numpy() - x), initial=0.0))
    assert err <= float(np.max(np.abs(x), initial=0.0)) / 127.0 + 1e-8
    if case == "ties":
        assert q[0, :6].tolist() == [127, 0, 2, 2, 0, -4]


def test_error_feedback_bit_equal_jax_and_unbiased():
    """50 steps of ``_ef_quantize`` (tests/test_infra.py's): every payload,
    scale and residual bit-equal to JAX's, and the applied sum within
    max|g| of 50·g."""
    rng = np.random.default_rng(1)
    g = (rng.standard_normal((256,)) * 1e-3).astype(np.float32)
    jerr, err = jnp.zeros_like(jnp.asarray(g)), torch.zeros(256)
    applied = torch.zeros(256)
    tg = torch.from_numpy(g)
    for _ in range(50):
        jq, js, jerr = jcompress._ef_quantize(jnp.asarray(g), jerr)
        q, s, err = compress._ef_quantize(tg, err)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
        applied = applied + compress.dequantize_int8(q, s, tg.shape, tg.dtype)
    np.testing.assert_allclose(applied.numpy(), 50 * g, atol=float(np.max(np.abs(g))))


def test_compressed_reduce_needs_the_parallel_layer():
    """The reduce over a 1-rank (pod, data, model) gloo mesh: one pod, so
    the mean is this rank's dequantized payload, bit-equal to
    ``dequantize_int8(_ef_quantize(...))`` and to JAX's, and the residual
    ``_ef_quantize``'s."""
    from repro_torch.launch.mesh import make_host_mesh, make_mesh, shutdown

    rng = np.random.default_rng(4)
    g = {"w": rng.standard_normal((3, 300)).astype(np.float32),
         "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    e = {"w": (rng.standard_normal((3, 300)) * 1e-3).astype(np.float32),
         "b": {"c": np.zeros(7, np.float32)}}
    tg, te = (tree_map(torch.from_numpy, t) for t in (g, e))
    try:
        make_host_mesh("cpu")
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), "cpu")
        mean, err = compress.compressed_grad_reduce(tg, te, mesh)
    finally:
        shutdown()
    for path in (("w",), ("b", "c")):
        x, ex, got, got_e = tg, te, mean, err
        for k in path:
            x, ex, got, got_e = x[k], ex[k], got[k], got_e[k]
        q, s, want_e = compress._ef_quantize(x, ex)
        want = compress.dequantize_int8(q, s, x.shape, x.dtype)
        assert torch.equal(got, want) and torch.equal(got_e, want_e)
        jq, js, _ = jcompress._ef_quantize(jnp.asarray(x.numpy()), jnp.asarray(ex.numpy()))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jcompress.dequantize_int8(jq, js, x.shape, jnp.float32)))
    err = compress.init_error_feedback({"a": torch.ones(3, dtype=torch.bfloat16),
                                        "b": {"c": torch.ones(2)}})
    assert err["a"].dtype == torch.float32 and torch.equal(err["b"]["c"], torch.zeros(2))


# ---------------------------------------------------------------------------
# DedupIndex
# ---------------------------------------------------------------------------


def _dedup_stream(seed=5, n_batches=3, width=32):
    """Batches of documents: new ones, repeats of earlier batches' and
    repeats inside the batch."""
    rng = np.random.default_rng(seed)
    history, batches = [], []
    for _ in range(n_batches):
        docs = []
        for _ in range(width):
            u = rng.random()
            if u < 0.3 and history:
                docs.append(history[rng.integers(len(history))])
            elif u < 0.4 and docs:
                docs.append(docs[rng.integers(len(docs))])
            else:
                docs.append(rng.integers(0, 1000, rng.integers(1, 20)).tolist())
        history += docs
        batches.append(docs)
    return batches


@pytest.mark.parametrize("mode", ["elim", "occ"])
def test_dedup_index_equals_jax(mode):
    cases = [[[1, 2, 3], [4, 5, 6], [1, 2, 3], [7, 8]], [[4, 5, 6], [9, 9]]]
    cases += _dedup_stream()
    j = jdedup.DedupIndex(capacity=1024, mode=mode)
    t = DedupIndex(capacity=1024, mode=mode, device="cpu")
    seen = set()
    for i, docs in enumerate(cases):
        assert [content_hash(d) for d in docs] == [jdedup.content_hash(d) for d in docs]
        jkeep, jst = j.filter_batch(docs)
        tkeep, tst = t.filter_batch(docs)
        assert tkeep == jkeep and tst == {k: int(v) for k, v in jst.items()}
        want = []
        for n, d in enumerate(docs):  # a set fed the same stream
            h = content_hash(d)
            if h not in seen:
                seen.add(h)
                want.append(n)
        assert tkeep == want
        if i == 0:
            assert tkeep == [0, 1, 3]
        if i == 1:
            assert tkeep == [1] and tst["duplicates"] == 2
    assert _pool_diff(j.tree, t.tree) == []
    assert t.tree.items() == j.tree.items()
    assert t.filter_batch([]) == ([], {})


def test_dedup_index_needs_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DedupIndex(capacity=64)


# ---------------------------------------------------------------------------
# the donating train step, engines and launchers on the new archs
# ---------------------------------------------------------------------------


def test_donating_step_equals_the_functional_step():
    cfg = reduced(get_config("granite-moe-3b-a800m"))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)).astype(np.int32))
    params = init_params(backbone.model_spec(cfg), "cpu", seed=2)
    kept = tree_map(torch.clone, params)
    want = make_train_step(cfg, schedule=constant_lr)(params, adamw_init(params), {"tokens": tokens}, 0)
    for a, b in zip(tree_leaves(params), tree_leaves(kept)):  # the step that does not donate
        assert torch.equal(a, b)
    mine = tree_map(torch.clone, params)
    opt = adamw_init(mine)
    step = make_train_step(cfg, schedule=constant_lr, donate=True)
    for _ in range(2):  # the second step updates moments that are not zero
        got = step(mine, opt, {"tokens": tokens}, 0)
        assert got.params is mine and got.opt_state.m is opt.m
        opt = got.opt_state
        if _ == 0:
            assert torch.equal(got.metrics["loss"], want.metrics["loss"])
            for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
                assert torch.equal(a, b)
            for a, b in zip(tree_leaves(got.opt_state.v), tree_leaves(want.opt_state.v)):
                assert torch.equal(a, b)
            want = make_train_step(cfg, schedule=constant_lr)(want.params, want.opt_state,
                                                              {"tokens": tokens}, 0)
    for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
        assert torch.equal(a, b)
    assert int(got.opt_state.count) == int(want.opt_state.count) == 2


def test_adamw_passes_of_layer_runs_equal_one_pass(monkeypatch):
    """The update pass over runs of whole layers (``CHUNK`` elements at
    most; 2^26 on the card, 40 here) equals one pass a leaf, bit for bit,
    decayed and undecayed leaves, clipped grads and a second step alike."""
    from repro_torch.optim import adamw

    rng = np.random.default_rng(4)
    mk = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    params = {"stack": mk(5, 3, 4), "table": mk(7, 9), "norm": mk(11)}
    grads = [tree_map(lambda p: mk(*p.shape) * 30.0, params) for _ in range(2)]
    outs = []
    for chunk in (adamw.CHUNK, 40):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        runs = [len(list(adamw._chunks(x))) for x in tree_leaves(params)]
        assert runs == ([1, 1, 1] if chunk == adamw.CHUNK and chunk > 40 else [2, 2, 1])
        p, opt = tree_map(torch.clone, params), adamw_init(params)
        for g in grads:
            g, _ = adamw.clip_by_global_norm(tree_map(torch.clone, g), 1.0, donate=True)
            p, opt = adamw.adamw_update(g, opt, p, torch.tensor(1e-2), donate=True)
        outs.append(tree_leaves(p) + tree_leaves(opt.m) + tree_leaves(opt.v))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


TINY_MOE_MLA = dict(name="tiny-moe-mla", family="moe", n_layers=2, d_model=32, n_heads=2,
                    n_kv=2, d_head=16, d_ff=64, vocab=64, attn="mla", q_lora=16, kv_lora=8,
                    rope_head=8, n_experts=4, top_k=2, d_ff_expert=16, n_shared=1,
                    first_k_dense=1, dtype="float32")


def test_engine_on_moe_and_mla_gives_jax_tokens(monkeypatch):
    """The serving engine on a latent cache and MoE layers: the same tokens
    as the JAX engine from the same params (one request joins while another
    runs, so the fused decode steps hold two rows).  The JAX engine is
    given seeded numpy params (``np_params``) in place of its own init,
    which compiles a random draw for each leaf's shape (~8 s here)."""
    monkeypatch.setattr(jengine, "init_params",
                        lambda spec: jax.tree.map(jnp.asarray, np_params(spec, seed=3)))
    jeng = jengine.ServeEngine(JModelConfig(**TINY_MOE_MLA), max_batch=2, s_max=32, n_pages=6)
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params))
    teng = ServeEngine(ModelConfig(**TINY_MOE_MLA), max_batch=2, s_max=32, n_pages=6,
                       device="cpu", params=params)
    assert teng.cache["layers"].v is None
    assert teng.params["layers"]["ffn"]["router"].dtype == torch.float32
    rng = np.random.default_rng(3)
    reqs = [(rid, rng.integers(0, 64, n).tolist(), m) for rid, n, m in ((0, 12, 4), (1, 7, 3), (2, 9, 3))]
    for eng, req in ((jeng, jengine.Request), (teng, Request)):
        for rid, prompt, max_new in reqs:
            eng.submit(req(rid=rid, prompt=prompt, max_new=max_new))
        eng.run_until_done(max_ticks=200)
    assert {r.rid: r.out for r in teng.done} == {r.rid: r.out for r in jeng.done}
    assert len(teng.done) == 3


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "internvl2-2b"])
def test_train_launcher_runs_the_new_archs(arch, tmp_path):
    from repro_torch.launch import train as launch

    out = launch.main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
                       "--ckpt", str(tmp_path)], device="cpu")
    assert out["final_step"] == 2 and np.isfinite(out["final_loss"])


def test_serve_launcher_runs_mla(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "deepseek-v3-671b", "--requests", "2", "--max-new", "2"], device="cpu")
    out = capsys.readouterr().out
    assert json.loads(out[: out.rindex("}") + 1])["n_done"] == 2
