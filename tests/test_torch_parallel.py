"""The port's parallel layer against the JAX package on the CPU.

* Specs, in process, with no process group: for every arch × every shape
  whose ``cell_status`` is ``run``, on the meshes (2,2,2), (4,2), (16,16)
  and (2,16,16) (the port's helpers read a ``{axis: size}`` mapping, JAX's
  an ``AbstractMesh``), ``batch_pspecs`` and ``cache_pspecs`` equal JAX's,
  and ``param_shardings`` equals JAX's under every rule set (both raise
  where a spec maps one axis to two dims).
* Multi-rank numerics on 8 gloo CPU ranks: one rank job a module
  (``rank_job``: this file run as a script, ``python
  tests/test_torch_parallel.py --ranks 8 OUT.json``, its ranks started by
  ``torch.multiprocessing`` over a ``FileStore``, single-threaded, importing
  torch and the port and never JAX); the parent computes the JAX
  references and one test a scenario reads the job's JSON:
  (a) a TP×DP train step on a (data=4, model=2) mesh: the loss within
      rtol 2e-4 of JAX's 1-device ``loss_fn`` (JAX's own bound); against
      the port's 1-device step, AdamW's moments within 1e-5 of each leaf's
      largest value, the params whose grad is far above AdamW's eps within
      1e-6, and the second step's loss within rtol 1e-5;
  (b) ``compressed_grad_reduce`` on (pod=2, data=2, model=2): each rank's
      ``q`` and ``scale`` bit-equal to JAX's ``_ef_quantize`` of its input,
      the mean over the pods equal to the f32 mean of the dequantized
      inputs (two addends: exact) and within 2e-2 of an input every rank
      shares (JAX's test);
  (c) ``pipeline_apply`` on a 4-stage pod mesh (pod=4, data=2) equal to
      the sequential stack within 1e-5;
  (d) the grouped MoE under a 2-rank data mesh (reduced granite,
      ``moe_groups=4``, 2 groups a rank) equal to the port's mesh-free
      grouped path and to JAX's mesh-free ``moe_apply`` within 1e-5; with
      its weights placed by each rule set, the dispatch gets the model
      axis's local shards (its experts or its hidden slice), and the
      output and the grads equal the mesh-free ones within 1e-5;
  (e) elastic restore: a checkpoint saved without a mesh restored onto the
      (4,2) mesh by ``param_shardings`` (values bit-equal, placements as
      asked), and one saved under the mesh (each shard sent to rank 0,
      splits that do not divide among them) restored without one;
  (f) decode steps of reduced qwen2 (GQA) and deepseek (MLA) on the (4,2)
      mesh, caches placed by ``cache_shardings`` at batch 8 (batch split)
      and 2 (sequence split), logits within 1e-5 of ``forward_decode``'s
      largest.

The same seeded numpy params (``np_params``) go to both packages.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
RANKS = 8
MESHES = [((2, 2, 2), ("pod", "data", "model")), ((4, 2), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
TP_SHAPE = dict(n_layers=2, d_model=64, n_heads=4, n_kv=2)
TP_BATCH = (8, 32)
TP_LR = 1e-3
TP_BIG_GRAD = 1e-4  # 1e4 × AdamW's eps: the grads whose params are held
REDUCE_N = 1000  # values a rank quantizes: 3 blocks and a padded one
PIPE = dict(n_stages=4, m=3, b=2, d=8)
MOE_X = (8, 16)
JOB_TIMEOUT_S = 240
SERVE_ARCHS = ("qwen2-0.5b", "deepseek-v3-671b")


def np_params(spec_tree, seed: int = 0):
    """Seeded numpy params for a spec tree (its init kinds and scales), in
    the tree's sorted order: the same arrays for both packages."""
    rng = np.random.default_rng(seed)

    def rec(t):
        if hasattr(t, "shape") and hasattr(t, "axes"):
            if t.init in ("zeros", "ones"):
                return np.full(t.shape, float(t.init == "ones"), np.float32)
            scale = 1.0 / np.sqrt(t.shape[-1]) if t.init == "embed" else t.scale
            return (rng.standard_normal(t.shape) * scale).astype(np.float32)
        return {k: rec(t[k]) for k in sorted(t)}

    return rec(spec_tree)


def tp_config():
    from repro_torch.configs import get_config
    from repro_torch.models import reduced

    return reduced(get_config("qwen2-0.5b"), **TP_SHAPE)


def moe_config():
    from repro_torch.configs import get_config
    from repro_torch.models import reduced

    return reduced(get_config("granite-moe-3b-a800m"), n_layers=1).replace(
        moe_groups=4, capacity_factor=8.0)


def _rel(a, b) -> float:
    """Largest difference of ``a`` from ``b`` over ``b``'s largest value."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def tp_tokens(vocab):
    return np.random.default_rng(1).integers(0, vocab, TP_BATCH).astype(np.int32)


def reduce_input(rank: int) -> np.ndarray:
    return np.random.default_rng(100 + rank).standard_normal(REDUCE_N).astype(np.float32)


def shared_input() -> np.ndarray:
    return np.random.default_rng(7).standard_normal(64).astype(np.float32)


def pipe_inputs():
    rng = np.random.default_rng(0)
    p = PIPE
    w = (rng.standard_normal((p["n_stages"], p["d"], p["d"])) * 0.3).astype(np.float32)
    x = rng.standard_normal((p["m"], p["b"], p["d"])).astype(np.float32)
    return w, x


def moe_input(d_model):
    return np.random.default_rng(3).standard_normal(MOE_X + (d_model,)).astype(np.float32)


# ---------------------------------------------------------------------------
# the rank job (no JAX here)
# ---------------------------------------------------------------------------


def _rank_main(rank, world, workdir, out_path):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    import torch.distributed as dist

    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        res = {"rank": rank}
        res.update(_scenarios(rank, workdir))
        gathered = [None] * world
        dist.all_gather_object(gathered, res)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(gathered, f)
    finally:
        dist.destroy_process_group()


def _scenarios(rank, workdir):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from repro_torch._shardmap_compat import NamedSharding, PartitionSpec, distribute, place
    from repro_torch.checkpoint import CheckpointManager, restore
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import backbone, moe
    from repro_torch.models.params import RULE_SETS, param_shardings
    from repro_torch.optim import adamw_init, constant_lr
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.parallel import compress
    from repro_torch.parallel.ctx import use_mesh
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.configs import get_config
    from repro_torch.models import reduced
    from repro_torch.parallel.sharding import cache_shardings
    from repro_torch.train import make_serve_step, make_train_step

    out = {}
    # (a) TP×DP train step on (data=4, model=2)
    cfg = tp_config()
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    params = params_from_numpy(np_params(backbone.model_spec(cfg)), "cpu")
    batch = {"tokens": torch.from_numpy(tp_tokens(cfg.vocab))}
    step = make_train_step(cfg, mesh, lr_peak=TP_LR, schedule=constant_lr)
    got = step(tree_map(torch.clone, params), adamw_init(params), batch, 0)
    got2 = step(got.params, got.opt_state, batch, 1)
    out["tp_loss"] = float(got.metrics["loss"])
    out["tp_grad_norm"] = float(got.metrics["grad_norm"])
    out["tp_loss2"] = float(got2.metrics["loss"])
    placed = tree_map(lambda p, s: isinstance(p, DTensor) and p.placements == s.placements,
                      got.params,
                      param_shardings(backbone.model_spec(cfg), mesh, RULE_SETS[cfg.rules]))
    out["tp_placed"] = all(tree_leaves(placed))
    full = [[x.full_tensor() for x in tree_leaves(t)]
            for t in (got.params, got.opt_state.m, got.opt_state.v)]
    if rank == 0:
        one = make_train_step(cfg, lr_peak=TP_LR, schedule=constant_lr)
        ref = one(tree_map(torch.clone, params), adamw_init(params), batch, 0)
        ref2 = one(ref.params, ref.opt_state, batch, 1)
        out["tp_loss_1dev"] = float(ref.metrics["loss"])
        out["tp_grad_norm_1dev"] = float(ref.metrics["grad_norm"])
        out["tp_loss2_1dev"] = float(ref2.metrics["loss"])
        p1, m1, v1 = (tree_leaves(t) for t in (ref.params, ref.opt_state.m, ref.opt_state.v))
        # the moments after one step are (1 - b) g and (1 - b) g²: linear in
        # the grad (and its square), so held leaf by leaf relative to the
        # leaf's largest value
        out["tp_m_rel"] = max(_rel(a, b) for a, b in zip(full[1], m1))
        out["tp_v_rel"] = max(_rel(a, b) for a, b in zip(full[2], v1))
        # the params where the grad is far above AdamW's eps, so that a
        # rounding of g moves g / (|g| + eps) by nothing that shows
        big = [b.abs() > TP_BIG_GRAD * (1 - 0.9) for b in m1]
        out["tp_param_big_frac"] = (sum(int(k.sum()) for k in big)
                                    / sum(k.numel() for k in big))
        out["tp_param_big_diff"] = max(float(torch.where(k, a - b, 0.0).abs().max())
                                       for a, b, k in zip(full[0], p1, big))

    # (b) compressed_grad_reduce on (pod=2, data=2, model=2)
    mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    g = {"w": torch.from_numpy(reduce_input(rank)), "shared": torch.from_numpy(shared_input())}
    err = compress.init_error_feedback(g)
    q, scale, e_ref = compress._ef_quantize(g["w"], err["w"])
    mean, err2 = compress.compressed_grad_reduce(g, err, mesh3)
    out["q"] = q.numpy().astype(int).tolist()
    out["scale"] = scale.numpy().tolist()
    out["mean"] = mean["w"].numpy().tolist()
    out["mean_shared"] = mean["shared"].numpy().tolist()
    out["err_equal"] = bool(torch.equal(err2["w"], e_ref))
    out["pod_peer"] = [int(r) for r in dist.get_process_group_ranks(mesh3.get_group("pod"))]

    # (c) pipeline_apply: 4 stages over pod, 2 replicas over data
    w, x = pipe_inputs()
    mesh_p = make_mesh((4, 2), ("pod", "data"), "cpu")
    wt = torch.from_numpy(w)
    pipe = pipeline_apply({"w": wt}, torch.from_numpy(x), lambda p, h: torch.tanh(h @ p["w"]),
                          mesh_p)
    out["pipeline"] = pipe.numpy().tolist()
    sharded = distribute(wt, NamedSharding(mesh_p, PartitionSpec("pod", None, None)))
    pipe2 = pipeline_apply({"w": sharded}, torch.from_numpy(x),
                           lambda p, h: torch.tanh(h @ p["w"]), mesh_p)
    out["pipeline_sharded_equal"] = bool(torch.equal(pipe, pipe2))

    # (d) grouped MoE on a 2-rank data mesh
    mcfg = moe_config()
    mesh_m = make_mesh((2, 4), ("data", "model"), "cpu")
    mp = params_from_numpy(np_params(moe.moe_spec(mcfg), seed=2), "cpu")
    xm = torch.from_numpy(moe_input(mcfg.d_model))
    xd = distribute(xm, NamedSharding(mesh_m, PartitionSpec("data", None, None)))
    with use_mesh(mesh_m):
        ym = moe.moe_apply(mp, xd, mcfg)
    out["moe_local_rows"] = int(ym.to_local().shape[0])
    ym = ym.full_tensor()
    out["moe_mesh"] = ym.numpy().tolist()
    out["moe_vs_meshfree"] = float((ym - moe.moe_apply(mp, xm, mcfg)).abs().max())
    # the expert weights placed by each rule set: the model axis keeps its
    # split inside the region (its local shards reach the dispatch), and
    # the output and every grad equal the mesh-free ones
    r_out = torch.from_numpy(moe_input(mcfg.d_model) * 0.5 + 1.0)
    live = tree_map(lambda a: a.clone().requires_grad_(), mp)
    x_live = xm.clone().requires_grad_()
    want_g = torch.autograd.grad((moe.moe_apply(live, x_live, mcfg) * r_out).sum(),
                                 tree_leaves(live) + [x_live])
    seen = []
    dispatch = moe._dispatch_ffn

    def spy(p_, *a):
        seen.append(list(p_["wi"].shape))
        return dispatch(p_, *a)

    moe._dispatch_ffn = spy
    out["moe_rules"] = {}
    for name, rules in RULE_SETS.items():
        placed = place(mp, param_shardings(moe.moe_spec(mcfg), mesh_m, rules))
        live = tree_map(lambda a: a.detach().requires_grad_(), placed)
        x_live = xd.detach().requires_grad_()
        seen.clear()
        with use_mesh(mesh_m):
            y = moe.moe_apply(live, x_live, mcfg)
            got_g = torch.autograd.grad((y.full_tensor() * r_out).sum(),
                                        tree_leaves(live) + [x_live])
        out["moe_rules"][name] = {
            "wi_local": seen[0],
            "y": float((y.detach().full_tensor() - ym).abs().max()),
            "grad_rel": max(_rel(a.full_tensor(), b) for a, b in zip(got_g, want_g)),
        }
    moe._dispatch_ffn = dispatch

    # (f) decode steps on (data=4, model=2): the caches placed by
    # ``cache_shardings`` (batch over data, or at batch 2 the sequence over
    # model and data), the attention on each rank's (batch, head) shard
    out["serve"] = {}
    for arch in SERVE_ARCHS:
        scfg = reduced(get_config(arch))
        sp = params_from_numpy(np_params(backbone.model_spec(scfg)), "cpu")
        for b in (8, 2):
            toks = torch.from_numpy(tp_tokens(scfg.vocab)[:b])
            want_cache = backbone.init_cache(scfg, b, 16, "cpu")
            cache = place(backbone.init_cache(scfg, b, 16, "cpu"),
                          cache_shardings(scfg, b, 16, mesh))
            serve = make_serve_step(scfg, mesh, b, 16)
            diff = 0.0
            for pos in range(3):
                want, _ = backbone.forward_decode(sp, want_cache, toks[:, pos], pos, scfg)
                got, _ = serve(sp, cache, toks[:, pos], pos)
                diff = max(diff, _rel(got.full_tensor(), want))
            out["serve"][f"{arch}/{b}"] = diff

    # (e) elastic restore
    spec = backbone.model_spec(cfg)
    state = {"params": params}
    sh = {"params": param_shardings(spec, mesh, RULE_SETS[cfg.rules])}
    plain_dir, mesh_dir = os.path.join(workdir, "ckpt_plain"), os.path.join(workdir, "ckpt_mesh")
    if rank == 0:
        CheckpointManager(plain_dir).save(1, state)
    dist.barrier()
    onto = restore(plain_dir, 1, state, sh)
    placed = tree_map(lambda a, s: isinstance(a, DTensor) and a.placements == s.placements,
                      onto["params"], sh["params"])
    eq = tree_map(lambda a, b: torch.equal(a.full_tensor(), b), onto["params"], params)
    out["restore_onto_mesh_equal"] = all(tree_leaves(eq))
    out["restore_onto_mesh_placed"] = all(tree_leaves(placed))
    # a leaf whose splits do not divide (7 rows over 4, 3 columns over 2)
    odd = torch.arange(21, dtype=torch.float32).reshape(7, 3)
    CheckpointManager(mesh_dir).save(
        2, {**onto, "odd": distribute_tensor(odd, mesh, [Shard(0), Shard(1)])})
    dist.barrier()
    back = restore(mesh_dir, 2, {**state, "odd": odd}, device="cpu")
    out["restore_off_mesh_equal"] = torch.equal(back["odd"], odd) and all(
        not isinstance(a, DTensor) and torch.equal(a, b)
        for a, b in zip(tree_leaves(back["params"]), tree_leaves(params)))
    return out


def run_job(out_path, world=RANKS):
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as workdir:
        mp.start_processes(_rank_main, args=(world, workdir, out_path), nprocs=world,
                           start_method="spawn")


@pytest.fixture(scope="module")
def rank_job(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks") / "ranks.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, __file__, "--ranks", str(RANKS), str(out)],
                          capture_output=True, text=True, timeout=JOB_TIMEOUT_S, env=env, cwd=ROOT)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    with open(out) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# specs against JAX's (no process group)
# ---------------------------------------------------------------------------


def _norm(spec):
    return tuple(tuple(e) if isinstance(e, tuple) else ((e,) if e is not None else ())
                 for e in spec)


def _jax_specs(tree):
    import jax

    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jax.tree_util.keystr(p): _norm(s) for p, s in leaves}


def _port_specs(tree, path=""):
    from repro_torch._shardmap_compat import PartitionSpec

    if tree is None:
        return {}
    if isinstance(tree, PartitionSpec):
        return {path: _norm(tree)}
    if hasattr(tree, "mesh") and hasattr(tree, "spec"):
        return {path: _norm(tree.spec)}
    if isinstance(tree, dict):
        items = tree.items()
        fmt = "[{!r}]"
    else:
        items = zip(tree._fields, tree)
        fmt = ".{}"
    out = {}
    for k, v in items:
        out.update(_port_specs(v, path + fmt.format(k)))
    return out


def _cells():
    from repro_torch.configs import ARCH_IDS, SHAPES, cell_status, get_config

    for arch in ARCH_IDS:
        for shape in SHAPES.values():
            if cell_status(get_config(arch), shape) == "run":
                yield arch, shape


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
def test_batch_and_cache_pspecs_equal_jax(mesh):
    import repro.core  # noqa: F401  (x64)
    from jax.sharding import AbstractMesh
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.launch.inputs import input_specs as jinput_specs
    from repro.parallel import sharding as jsh

    from repro_torch.configs import get_config
    from repro_torch.launch.inputs import input_specs
    from repro_torch.parallel import sharding

    shape, axes = mesh
    am, sizes = AbstractMesh(shape, axes), dict(zip(axes, shape))
    n = 0
    for arch, sh in _cells():
        jc, tc = jget(arch), get_config(arch)
        jin, tin = jinput_specs(jc, JSHAPES[sh.name]), input_specs(tc, sh)
        if sh.kind == "decode":
            jin, tin = {"tokens": jin["tokens"]}, {"tokens": tin["tokens"]}
            want = _jax_specs(jsh.cache_pspecs(jc, sh.batch, sh.seq, am))
            got = _port_specs(sharding.cache_pspecs(tc, sh.batch, sh.seq, sizes))
            assert got == want, (arch, sh.name)
            n += len(want)
        assert _port_specs(sharding.batch_pspecs(tc, tin, sizes)) == \
            _jax_specs(jsh.batch_pspecs(jc, jin, am)), (arch, sh.name)
    assert n > 0


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
def test_param_shardings_equal_jax_under_every_rule_set(mesh):
    from jax.sharding import AbstractMesh
    from repro.configs import get_config as jget
    from repro.models import backbone as jbackbone
    from repro.models.params import RULE_SETS as JRULES
    from repro.models.params import param_shardings as jparam_shardings

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import backbone
    from repro_torch.models.params import RULE_SETS, param_shardings

    shape, axes = mesh
    am, sizes = AbstractMesh(shape, axes), dict(zip(axes, shape))
    assert list(RULE_SETS) == list(JRULES) and RULE_SETS == JRULES
    raised = []
    for arch in ARCH_IDS:
        jc, tc = jget(arch), get_config(arch)
        for name in [tc.rules] + list(RULE_SETS):
            try:
                want = _jax_specs(jax_tree_specs(jparam_shardings(
                    jbackbone.model_spec(jc), am, JRULES[name])))
            except Exception as e:  # noqa: BLE001 — JAX's DuplicateSpecError alone
                assert "Duplicate" in type(e).__name__, e
                want = None
            try:
                got = _port_specs(param_shardings(backbone.model_spec(tc), sizes, RULE_SETS[name]))
            except ValueError:
                got = None
            assert got == want, (arch, name)
            if want is None:
                raised.append((arch, name))
    # vis_proj (embed, embed) under the FSDP rules: 'data' on both dims
    assert {a for a, _ in raised} <= {"internvl2-2b"}


def jax_tree_specs(tree):
    """JAX NamedShardings → their specs, keyed like the port's dict paths."""
    import jax

    return jax.tree.map(lambda s: s.spec, tree)


def test_steps_on_a_host_mesh_equal_meshfree():
    """On the 1-rank gloo host mesh, the serve step (its cache placed by
    ``cache_shardings`` and written in place) and the prefill step give
    the mesh-free logits and cache bit for bit."""
    from torch.distributed.tensor import DTensor

    from repro_torch._shardmap_compat import place
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.mesh import make_host_mesh, shutdown
    from repro_torch.models import backbone
    from repro_torch.parallel.sharding import cache_shardings
    from repro_torch.train import make_prefill_step, make_serve_step

    cfg = tp_config()
    params = params_from_numpy(np_params(backbone.model_spec(cfg)), "cpu")
    tokens = torch.from_numpy(tp_tokens(cfg.vocab))
    b, s_max = tokens.shape[0], 16
    want_cache = backbone.init_cache(cfg, b, s_max, "cpu")
    try:
        mesh = make_host_mesh("cpu")
        cache = place(backbone.init_cache(cfg, b, s_max, "cpu"),
                      cache_shardings(cfg, b, s_max, mesh))
        serve = make_serve_step(cfg, mesh, b, s_max)
        for pos in range(3):
            want, _ = backbone.forward_decode(params, want_cache, tokens[:, pos], pos, cfg)
            got, out_cache = serve(params, cache, tokens[:, pos], pos)
            assert out_cache["layers"].k is cache["layers"].k
            assert torch.equal(got.full_tensor(), want)
        assert isinstance(cache["layers"].k, DTensor)
        assert torch.equal(cache["layers"].k.full_tensor(), want_cache["layers"].k)
        batch = {"tokens": tokens}
        assert torch.equal(make_prefill_step(cfg, mesh)(params, batch).full_tensor(),
                           make_prefill_step(cfg)(params, batch))
    finally:
        shutdown()


@pytest.mark.parametrize("arch,remat", [("deepseek-v3-671b", "dots"),
                                        ("deepseek-v3-671b", "full"), ("yi-34b", "dots")])
def test_remat_recompute_runs_under_the_forwards_mesh(arch, remat, monkeypatch):
    """On the 1-rank gloo host mesh, a reduced train step checkpointed as
    ``remat`` says (deepseek's and yi-34b's own is ``dots``): every layer's
    FFN runs twice, in the forward and in the recompute, both under the
    mesh (so the MoE's local region and the constraints run again as they
    ran), and the loss and params equal the mesh-free step's bit for bit;
    the same holds where the backward runs on another thread than the
    forward, as the card's autograd engine runs it."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch._shardmap_compat import place
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.mesh import make_host_mesh, shutdown
    from repro_torch.models import backbone, reduced
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.parallel.ctx import current_mesh, use_mesh
    from repro_torch.parallel.sharding import batch_shardings
    from repro_torch.train import make_train_step
    from repro_torch.train.step import state_shardings

    cfg = reduced(get_config(arch)).replace(remat=remat)
    params = params_from_numpy(np_params(backbone.model_spec(cfg)), "cpu")
    batch = {"tokens": torch.from_numpy(tp_tokens(cfg.vocab)[:2, :16])}
    seen = []
    ffn = backbone._ffn

    def spy(*a, **kw):
        seen.append(current_mesh())
        return ffn(*a, **kw)

    monkeypatch.setattr(backbone, "_ffn", spy)
    want = make_train_step(cfg)(tree_map(torch.clone, params), adamw_init(params), batch, 0)
    assert seen == [None] * 2 * cfg.n_layers
    seen.clear()
    try:
        mesh = make_host_mesh("cpu")
        got = make_train_step(cfg, mesh)(tree_map(torch.clone, params), adamw_init(params),
                                         batch, 0)
        assert seen == [mesh] * 2 * cfg.n_layers
        assert torch.equal(got.metrics["loss"], want.metrics["loss"])
        for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
            assert isinstance(a, DTensor) and torch.equal(a.full_tensor(), b)
        # the card's autograd engine runs the backward on a thread of its
        # own, which inherits the caller's torch state (implicit
        # replication among it) but none of its context variables: so here
        live = tree_map(lambda p: p.detach().requires_grad_(),
                        place(params, state_shardings(cfg, mesh)["params"]))
        seen.clear()
        grads = []

        def backward():
            with implicit_replication():
                grads.extend(torch.autograd.grad(loss, tree_leaves(live)))

        with use_mesh(mesh):
            loss, _ = backbone.loss_fn(live, place(batch, batch_shardings(cfg, batch, mesh)), cfg)
            worker = threading.Thread(target=backward)
            worker.start()
            worker.join()
        assert seen == [mesh] * 2 * cfg.n_layers
        assert [g.full_tensor().shape for g in grads] == [p.shape for p in tree_leaves(live)]
    finally:
        shutdown()


# ---------------------------------------------------------------------------
# the rank job's scenarios
# ---------------------------------------------------------------------------


def test_tp_dp_train_step_matches_jax_and_one_device(rank_job):
    import repro.core  # noqa: F401
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import backbone as jbackbone
    from repro.models import reduced as jreduced

    from repro_torch.models import backbone

    jcfg = jreduced(jget("qwen2-0.5b"), **TP_SHAPE)
    cfg = tp_config()
    params = np_params(backbone.model_spec(cfg))
    jl, _ = jbackbone.loss_fn(jax.tree.map(jnp.asarray, params),
                              {"tokens": jnp.asarray(tp_tokens(cfg.vocab))}, jcfg)
    r0 = rank_job[0]
    losses = {r["tp_loss"] for r in rank_job}
    assert len(losses) == 1  # every rank reports the same loss
    np.testing.assert_allclose(r0["tp_loss"], float(jl), rtol=2e-4)
    np.testing.assert_allclose(r0["tp_loss"], r0["tp_loss_1dev"], rtol=1e-5)
    np.testing.assert_allclose(r0["tp_grad_norm"], r0["tp_grad_norm_1dev"], rtol=1e-4)
    # AdamW's moments and the params it moved, against the 1-device step's:
    # 8.4e-7, 1.3e-6 and 3.0e-8 measured (f32 sums in another order), each
    # bound far below what a misplaced shard shows (an O(1) relative moment,
    # an O(lr) param)
    assert r0["tp_m_rel"] <= 1e-5 and r0["tp_v_rel"] <= 1e-5
    assert r0["tp_param_big_frac"] > 0.5
    assert r0["tp_param_big_diff"] <= 1e-6
    np.testing.assert_allclose(r0["tp_loss2"], r0["tp_loss2_1dev"], rtol=1e-5)
    assert all(r["tp_placed"] for r in rank_job)


def test_compressed_grad_reduce_matches_jax_quantizer(rank_job):
    import repro.core  # noqa: F401
    import jax.numpy as jnp
    from repro.parallel import compress as jcompress

    deq = {}
    for r in rank_job:
        x = jnp.asarray(reduce_input(r["rank"]))
        q, scale, _ = jcompress._ef_quantize(x, jnp.zeros_like(x))
        np.testing.assert_array_equal(np.asarray(r["q"]), np.asarray(q).astype(int))
        np.testing.assert_array_equal(np.asarray(r["scale"], np.float32), np.asarray(scale))
        deq[r["rank"]] = np.asarray(jcompress.dequantize_int8(q, scale, x.shape, jnp.float32))
        assert r["err_equal"]
    for r in rank_job:
        peers = r["pod_peer"]
        assert len(peers) == 2 and r["rank"] in peers
        want = (deq[peers[0]] + deq[peers[1]]) / np.float32(2)
        np.testing.assert_array_equal(np.asarray(r["mean"], np.float32), want)
        np.testing.assert_allclose(np.asarray(r["mean_shared"]), shared_input(), atol=2e-2)


def test_pipeline_matches_sequential(rank_job):
    w, x = pipe_inputs()
    ref = x
    for s in range(PIPE["n_stages"]):
        ref = np.tanh(ref @ w[s])
    for r in rank_job:
        np.testing.assert_allclose(np.asarray(r["pipeline"]), ref, atol=1e-5)
        assert r["pipeline_sharded_equal"]


def test_grouped_moe_under_a_mesh_matches_meshfree(rank_job):
    import repro.core  # noqa: F401
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import moe as jmoe
    from repro.models import reduced as jreduced

    from repro_torch.models import moe

    cfg = moe_config()
    jcfg = jreduced(jget("granite-moe-3b-a800m"), n_layers=1).replace(
        moe_groups=4, capacity_factor=8.0)
    p = np_params(moe.moe_spec(cfg), seed=2)
    want = np.asarray(jmoe.moe_apply(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(moe_input(cfg.d_model)), jcfg))
    e, f = cfg.n_experts, cfg.d_ff_expert
    local = {"tp": [e, cfg.d_model, f // 4], "fsdp_tp": [e, cfg.d_model, f // 4],
             "ep": [e // 4, cfg.d_model, f], "ep_fsdp": [e // 4, cfg.d_model, f]}
    for r in rank_job:
        assert r["moe_local_rows"] == MOE_X[0] // 2  # each rank dispatched its own groups
        assert r["moe_vs_meshfree"] <= 1e-5
        np.testing.assert_allclose(np.asarray(r["moe_mesh"]), want, atol=1e-5)
        for name, got in r["moe_rules"].items():
            # the model axis (4) keeps its split inside the region; embed's
            # FSDP split over data is gathered
            assert got["wi_local"] == local[name], name
            assert got["y"] <= 1e-5, name
            assert got["grad_rel"] <= 1e-5, (name, got["grad_rel"])


def test_serve_steps_on_a_mesh_match_meshfree(rank_job):
    for r in rank_job:
        assert sorted(r["serve"]) == sorted(f"{a}/{b}" for a in SERVE_ARCHS for b in (8, 2))
        for case, diff in r["serve"].items():
            assert diff <= 1e-5, (case, diff)


def test_elastic_restore_both_ways(rank_job):
    for r in rank_job:
        assert r["restore_onto_mesh_equal"] and r["restore_onto_mesh_placed"]
        assert r["restore_off_mesh_equal"]


if __name__ == "__main__":
    _, flag, world, out_json = sys.argv
    assert flag == "--ranks"
    run_job(out_json, int(world))
