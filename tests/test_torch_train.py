"""The port's training path against the JAX package on the CPU.

On ``reduced(qwen2-0.5b)`` (2 layers, f32) with the JAX package's params
carried across by ``repro_torch.interop``: ``forward_train`` logits within
1e-4, ``loss_fn`` within 1e-5 and every grad leaf, by name, within rtol
1e-4 / atol 1e-6 (f32 products summed in another order).  The optimizer
fed identical grads and state (params, m and v within 1e-6, ``count``
equal), the schedules at fixed steps, the data stream (bit-equal, resumed
mid-stream too) and checkpoints in both directions (bit-equal leaves, same
names).  The port's ``Trainer`` crash → restart → resume scenario of
``tests/test_infra.py`` must end bit-equal to an uninterrupted run, and the
launcher must run."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.checkpoint import restore as jrestore  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import make_data_iter as jmake_data_iter  # noqa: E402
from repro.models import backbone as jbackbone  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models.config import reduced as jreduced  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jschedules  # noqa: E402

from repro_torch.checkpoint import CheckpointManager, checkpoint_extra, latest_step, restore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import TreeConfig  # noqa: E402
from repro_torch.core.abtree import make_tree  # noqa: E402
from repro_torch.data import make_data_iter  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    opt_state_from_numpy,
    opt_state_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.models import backbone, init_params, reduced  # noqa: E402
from repro_torch.models.params import _walk  # noqa: E402
from repro_torch.optim.adamw import tree_map  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    constant_lr,
    warmup_cosine,
)
from repro_torch.train import (  # noqa: E402
    SimulatedFailure,
    Trainer,
    TrainerConfig,
    make_prefill_step,
    make_train_step,
)

ARCH = "qwen2-0.5b"
B, S = 2, 24


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """``{"a/b": leaf}`` of a nested dict."""
    if isinstance(tree, dict):
        return {n: x for k, v in tree.items() for n, x in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def run():
    """Both packages' forward, loss and grads on the same params and
    tokens (the JAX package's initialized params, seeded tokens)."""
    t, j = reduced(get_config(ARCH)), jreduced(jget_config(ARCH))
    jp = jparams.init_params(jbackbone.model_spec(j))
    tokens = np.random.default_rng(0).integers(0, t.vocab, (B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens)}
    jlogits = jbackbone.forward_train(jp, jb["tokens"], j)
    (jl, _), jg = jax.value_and_grad(lambda p: jbackbone.loss_fn(p, jb, j), has_aux=True)(jp)
    tp = params_from_numpy(_np_tree(jp))
    tb = {"tokens": torch.from_numpy(tokens)}
    tlogits = backbone.forward_train(tp, tb["tokens"], t)
    live = tree_map(lambda x: x.requires_grad_(), params_from_numpy(_np_tree(jp)))
    tl, metrics = backbone.loss_fn(live, tb, t)
    tl.backward()
    return dict(t=t, j=j, jp=jp, tp=tp, tokens=tokens, jlogits=np.asarray(jlogits),
                tlogits=tlogits.numpy(), jl=float(jl), tl=float(tl.detach()),
                ppl=float(metrics["ppl"].detach()), jg=_flat(_np_tree(jg)),
                tg={n: x.grad.numpy() for n, x in _flat(live).items()})


LEAVES = sorted(p[1:] for p, _ in _walk(backbone.model_spec(reduced(get_config(ARCH)))))


def test_forward_train_equals_jax(run):
    assert run["tlogits"].shape == (B, S, run["t"].vocab) and run["tlogits"].dtype == np.float32
    np.testing.assert_allclose(run["tlogits"], run["jlogits"], atol=1e-4, rtol=1e-4)


def test_loss_equals_jax(run):
    np.testing.assert_allclose(run["tl"], run["jl"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(run["ppl"], np.exp(run["jl"]), rtol=1e-5)


@pytest.mark.parametrize("leaf", LEAVES)
def test_grad_leaf_equals_jax(run, leaf):
    assert set(run["tg"]) == set(run["jg"]) == set(LEAVES)
    np.testing.assert_allclose(run["tg"][leaf], run["jg"][leaf], rtol=1e-4, atol=1e-6)


def test_remat_full_gives_the_same_loss_and_grads(run):
    t = run["t"]
    tb = {"tokens": torch.from_numpy(run["tokens"])}
    outs = []
    for cfg in (t, t.replace(remat="full"), t.replace(remat="dots")):
        out = make_train_step(cfg, schedule=constant_lr)(run["tp"], adamw_init(run["tp"]), tb, 0)
        outs.append(out)
    for other in outs[1:]:  # "full" and "dots" both
        assert torch.equal(outs[0].metrics["loss"], other.metrics["loss"])
        for a, b in zip(_flat(outs[0].params).values(), _flat(other.params).values()):
            torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_microbatches_average_to_the_full_batch(run):
    """Two microbatches of one row: loss and grads are their mean, which on
    equal halves is the full batch's."""
    tb = {"tokens": torch.from_numpy(run["tokens"])}
    full = make_train_step(run["t"], schedule=constant_lr)(run["tp"], adamw_init(run["tp"]), tb, 0)
    micro = make_train_step(run["t"], schedule=constant_lr, microbatch=1)(
        run["tp"], adamw_init(run["tp"]), tb, 0)
    torch.testing.assert_close(micro.metrics["loss"], full.metrics["loss"], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(micro.metrics["grad_norm"], full.metrics["grad_norm"],
                               atol=1e-6, rtol=1e-5)


def test_prefill_step_is_the_last_position(run):
    tb = {"tokens": torch.from_numpy(run["tokens"])}
    got = make_prefill_step(run["t"])(run["tp"], tb)
    np.testing.assert_array_equal(got.numpy(), run["tlogits"][:, -1])


def _grads_like(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.01).astype(np.float32),
                        _np_tree(params))


def test_clip_and_adamw_update_equal_jax(run):
    """Two optimizer steps, each fed the same grads and state in both
    packages: params, m and v within 1e-6, ``count`` equal."""
    jp, tp = run["jp"], run["tp"]
    jopt = jadamw.adamw_init(jp)
    topt = opt_state_from_numpy(_np_tree(jopt))
    for i, lr in enumerate((1e-3, 3e-4)):
        g = _grads_like(jp, seed=i)
        g["layers"]["attn"]["wq"] *= 300.0  # a global norm above the clip
        jgc, jgn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
        tgc, tgn = clip_by_global_norm(params_from_numpy(g), 1.0)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
        for n, x in _flat(params_to_numpy(tgc)).items():
            np.testing.assert_allclose(x, np.asarray(_flat(_np_tree(jgc))[n]), atol=1e-7, rtol=1e-6)
        jp, jopt = jadamw.adamw_update(jgc, jopt, jp, jnp.float32(lr))
        tp, topt = adamw_update(tgc, topt, tp, torch.tensor(lr, dtype=torch.float32))
        got_o, want_o = opt_state_to_numpy(topt), _np_tree(jopt)
        assert got_o["count"].dtype == np.int32 and int(got_o["count"]) == int(want_o.count) == i + 1
        for got, want in ((params_to_numpy(tp), _np_tree(jp)), (got_o["m"], want_o.m),
                          (got_o["v"], want_o.v)):
            want = _flat(want)
            for n, x in _flat(got).items():
                np.testing.assert_allclose(x, want[n], atol=1e-6, rtol=1e-6, err_msg=n)


@pytest.mark.parametrize("step", [0, 1, 50, 100, 5_000, 10_000])
def test_schedules_equal_jax(step):
    want = np.asarray(jschedules.warmup_cosine(jnp.int32(step), peak=3e-4))
    got = warmup_cosine(step, peak=3e-4)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        constant_lr(torch.tensor(step, dtype=torch.int32), peak=1e-3).numpy(),
        np.asarray(jschedules.constant_lr(jnp.int32(step), peak=1e-3)),
    )


def test_data_stream_equals_jax_and_resumes():
    t, j = reduced(get_config(ARCH)), jreduced(jget_config(ARCH))
    for start in (0, 3):
        mine = make_data_iter(t, batch=4, seq=16, seed=1, start_step=start)
        ref = jmake_data_iter(j, batch=4, seq=16, seed=1, start_step=start)
        for _ in range(4):
            a, b = next(mine), next(ref)
            assert a.keys() == b.keys() == {"tokens"}
            assert a["tokens"].dtype == b["tokens"].dtype == np.int32
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
    full = make_data_iter(t, batch=4, seq=16, seed=1)
    seq = [next(full)["tokens"] for _ in range(5)]
    resumed = make_data_iter(t, batch=4, seq=16, seed=1, start_step=3)
    np.testing.assert_array_equal(next(resumed)["tokens"], seq[3])


def _ckpt_state(run):
    """A (params, OptState) after one JAX AdamW step: every leaf nonzero."""
    jp = run["jp"]
    jopt = jadamw.adamw_init(jp)
    jp, jopt = jadamw.adamw_update(jax.tree.map(jnp.asarray, _grads_like(jp, 5)), jopt, jp,
                                   jnp.float32(1e-3))
    return jp, jopt


def _index(directory, step):
    with open(f"{directory}/step_{step:08d}/index.json") as f:
        return json.load(f)["index"]


def test_port_checkpoint_restores_in_jax(run, tmp_path):
    jp, jopt = _ckpt_state(run)
    tstate = {"params": params_from_numpy(_np_tree(jp)), "opt": opt_state_from_numpy(_np_tree(jopt))}
    CheckpointManager(str(tmp_path / "t")).save(7, tstate, extra={"step": 7})
    CheckpointManager(str(tmp_path / "j")).save(7, {"params": jp, "opt": jopt}, extra={"step": 7})
    assert _index(tmp_path / "t", 7) == _index(tmp_path / "j", 7)
    like = {"params": jp, "opt": jadamw.adamw_init(jp)}
    got = jrestore(str(tmp_path / "t"), 7, like)
    want = {"params": jp, "opt": jopt}
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_jax_checkpoint_restores_in_port(run, tmp_path):
    jp, jopt = _ckpt_state(run)
    JCheckpointManager(str(tmp_path)).save(3, {"params": jp, "opt": jopt}, extra={"note": "x"})
    assert latest_step(str(tmp_path)) == 3 and checkpoint_extra(str(tmp_path), 3) == {"note": "x"}
    like = {"params": run["tp"], "opt": adamw_init(run["tp"])}
    got = restore(str(tmp_path), 3, like, device="cpu")
    assert isinstance(got["opt"], OptState)
    assert got["opt"].count.dtype == torch.int32 and int(got["opt"].count) == 1
    want = {"params": params_to_numpy(got["params"]), **opt_state_to_numpy(got["opt"])}
    ref = {"params": _np_tree(jp), "m": _np_tree(jopt.m), "v": _np_tree(jopt.v),
           "count": np.asarray(jopt.count)}
    for name in ("params", "m", "v"):
        a, b = _flat(want[name]), _flat(ref[name])
        assert a.keys() == b.keys()
        for n in a:
            assert a[n].dtype == b[n].dtype
            np.testing.assert_array_equal(a[n], b[n])
    np.testing.assert_array_equal(want["count"], ref["count"])


def _trainer(tmp, cfg, **kw):
    mk_iter = lambda step: make_data_iter(cfg, batch=4, seq=16, start_step=step)
    tcfg = TrainerConfig(ckpt_dir=str(tmp), max_steps=12, ckpt_every=4, log_every=1, **kw)
    return Trainer(cfg, tcfg, mk_iter, device="cpu")


def test_trainer_crash_restart_resume_equals_uninterrupted(tmp_path):
    """tests/test_infra.py's scenario on the port: a crash at step 6, a
    restart that resumes from the step-4 checkpoint and ends at 12, bit-equal
    to 12 steps without a crash."""
    cfg = reduced(get_config(ARCH), n_layers=1)
    t1 = _trainer(tmp_path / "crash", cfg, fail_at_step=6)
    assert t1.resumed_from is None
    with pytest.raises(SimulatedFailure):
        t1.run()
    assert latest_step(str(tmp_path / "crash")) == 4
    t2 = _trainer(tmp_path / "crash", cfg)
    assert t2.resumed_from == 4 and t2.step == 4
    out = t2.run()
    assert out["final_step"] == 12 and np.isfinite(out["final_loss"])
    assert [h["step"] for h in out["history"]] == list(range(5, 13))
    assert latest_step(str(tmp_path / "crash")) == 12
    ref = _trainer(tmp_path / "clean", cfg)
    want = ref.run()
    assert want["final_loss"] == out["final_loss"]
    for a, b in zip(_flat(t2.params).values(), _flat(ref.params).values()):
        assert torch.equal(a, b)
    for a, b in zip(_flat(t2.opt.m).values(), _flat(ref.opt.m).values()):
        assert torch.equal(a, b)
    assert int(t2.opt.count) == int(ref.opt.count) == 12


def test_trainer_launcher_and_builders_need_a_device_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config(ARCH), n_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path)), lambda s: iter(()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(backbone.model_spec(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backbone.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_tree(TreeConfig(capacity=16, b=8, a=2, max_height=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore(str(tmp_path), 0, {})
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_host_mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()

    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--arch", ARCH, "--ckpt", str(tmp_path / "c")])


def test_launcher_runs_and_refuses_a_mesh(tmp_path, capsys):
    from repro_torch.launch import train as launch

    argv = ["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
            "--ckpt", str(tmp_path)]
    out = launch.main(argv, device="cpu")
    assert out["final_step"] == 2 and np.isfinite(out["final_loss"])
    assert latest_step(str(tmp_path)) == 2
    again = launch.main(argv[:4] + ["4"] + argv[5:], device="cpu")
    assert again["resumed_from"] == 2 and again["final_step"] == 4
    assert "resumed from durable checkpoint at step 2" in capsys.readouterr().out
    # on the 1-rank host mesh (gloo on the CPU): DTensor state, the same losses
    from repro_torch.launch.mesh import shutdown

    try:
        meshed = launch.main(argv[:-1] + [str(tmp_path / "mesh"), "--mesh", "host"], device="cpu")
        assert meshed["final_step"] == 2 and meshed["final_loss"] == out["final_loss"]
        resumed = launch.main(argv[:4] + ["4"] + argv[5:-1] + [str(tmp_path / "mesh"), "--mesh",
                                                                 "host"], device="cpu")
        assert resumed["resumed_from"] == 2 and resumed["final_loss"] == again["final_loss"]
        # the production meshes need a world of 256 / 512 ranks: the dry-run's
        with pytest.raises(ValueError, match="dry-run"):
            launch.build_trainer(launch.parse_args(["--arch", ARCH, "--reduced", "--ckpt",
                                                    str(tmp_path / "x"), "--mesh", "single"]),
                                 device="cpu")
    finally:
        shutdown()
