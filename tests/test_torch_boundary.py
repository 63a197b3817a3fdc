"""Boundary of the port: ``src/repro_torch``, ``chip_smoke.py``, the
port's chip tools under ``tools/`` and its examples (``examples/*_torch.py``)
import neither JAX nor the JAX package; the tree, the forest, their
durable variants and recovery refuse to drop to the CPU on their own; and every kernel wrapper sends a
CUDA tensor to its kernel, never to the plain version."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    ABForest,
    ABTree,
    DurableABTree,
    DurableForest,
    TreeConfig,
    recover,
)
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as da_kernel, ops as da_ops, ref as da_ref  # noqa: E402
from repro_torch.kernels.elim_combine import kernel as ec_kernel, ops as ec_ops, ref as ec_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel, ops as fa_ops, ref as fa_ref  # noqa: E402
from repro_torch.kernels.leaf_probe import kernel as lp_kernel, ops as lp_ops, ref as lp_ref  # noqa: E402
from repro_torch.kernels.range_scan import kernel as rs_kernel, ops as rs_ops, ref as rs_ref  # noqa: E402
from repro_torch.kernels.tree_descend import kernel as td_kernel, ops as td_ops, ref as td_ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tools").glob("*.py")) + sorted((ROOT / "examples").glob("*_torch.py")))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"abtree.py", "rounds.py", "forest.py", "elimination.py", "chip_smoke.py", "_lib.py",
            "engine.py", "pages.py", "backbone.py", "attention.py", "trainer.py", "step.py",
            "adamw.py", "manager.py", "pipeline.py", "tree_kernel_ab.py", "durable.py",
            "faults.py", "xlstm.py", "ssm.py", "_shardmap_compat.py", "mesh.py", "ctx.py",
            "sharding.py", "compress.py", "inputs.py", "dryrun.py", "roofline.py",
            "optimized.py", "report.py", "scan_correction.py", "quickstart_torch.py",
            "durable_store_torch.py", "serve_engine_torch.py", "train_lm_torch.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = {r for r in _imported_roots(path) if r in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_tree_without_device_raises_on_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ABTree(TreeConfig(capacity=64, b=8, a=2, max_height=8))


def test_forest_without_device_raises_on_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ABForest(2, TreeConfig(capacity=64, b=8, a=2, max_height=8))


@pytest.mark.parametrize("build", [
    lambda d: DurableABTree(d, TreeConfig(capacity=64, b=8, a=2, max_height=8)),
    lambda d: DurableForest(d, 2, TreeConfig(capacity=64, b=8, a=2, max_height=8)),
    recover,
], ids=["DurableABTree", "DurableForest", "recover"])
def test_durable_without_device_raises_on_a_host_without_cuda(monkeypatch, tmp_path, build):
    """Neither a durable holder nor recovery runs on the CPU unless asked:
    both raise before they touch the directory."""
    d = tmp_path / "journal"
    DurableABTree(str(d), TreeConfig(capacity=64, b=8, a=2, max_height=8), device="cpu").close()
    listing = sorted(p.name for p in d.iterdir())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(str(d))
    assert sorted(p.name for p in d.iterdir()) == listing


class _Reached(Exception):
    pass


def _wrappers():
    i64 = torch.zeros((1, 4), dtype=torch.int64)
    pool = torch.zeros((1, 5, 4), dtype=torch.int64)
    return [
        ("descend_probe", td_ops.descend_probe, (pool, pool, pool.int(), torch.ones((1, 5), dtype=torch.bool),
                                                 torch.zeros(1, dtype=torch.int32), i64),
         dict(max_height=4, notfound=-1), td_kernel, "descend_probe_cuda", td_ref, "descend_probe_ref"),
        ("frontier_compact", td_ops.frontier_compact, (i64.int(), i64.bool(), 2), dict(scratch=4),
         td_kernel, "frontier_compact_cuda", td_ref, "frontier_compact_plain"),
        ("elim_combine", ec_ops.elim_combine, (i64.int(), i64, i64.bool(), i64.bool(), i64), {},
         ec_kernel, "elim_combine_cuda", ec_ref, "elim_combine_ref"),
        ("range_scan", rs_ops.range_scan, (i64, i64, i64[0, :1], i64[0, :1]), dict(cap=2),
         rs_kernel, "range_scan_cuda", rs_ref, "range_scan_ref"),
        ("decode_attention", da_ops.decode_attention,
         (torch.zeros((1, 2, 64)), torch.zeros((1, 1, 8, 64)), torch.zeros((1, 1, 8, 64)), 3), {},
         da_kernel, "decode_attention_cuda", da_ref, "decode_attention_ref"),
        ("flash_attention", fa_ops.flash_attention,
         (torch.zeros((1, 2, 8, 32)), torch.zeros((1, 1, 8, 32)), torch.zeros((1, 1, 8, 32))), {},
         fa_kernel, "flash_attention_cuda", fa_ref, "attention_ref"),
        ("leaf_probe", lp_ops.leaf_probe, (i64, i64, i64[:, 0]), {},
         lp_kernel, "leaf_probe_cuda", lp_ref, "leaf_probe_ref"),
        ("leaf_probe_i64", lp_ops.leaf_probe_i64, (i64, i64.int(), i64[:, 0]), {},
         lp_kernel, "leaf_probe_cuda", lp_ref, "leaf_probe_ref"),
    ]


@pytest.mark.parametrize("case", _wrappers(), ids=lambda c: c[0])
def test_cuda_tensors_never_reach_the_plain_version(monkeypatch, case):
    """With every tensor reporting CUDA, the wrapper calls the kernel
    launcher and never the plain version (no fallback)."""
    name, wrapper, args, kw, kmod, kfn, rmod, rfn = case
    calls = []

    def kernel_spy(*a, **k):
        calls.append(name)
        raise _Reached

    def plain_trap(*a, **k):
        raise AssertionError(f"{name}: CUDA input reached the plain version")

    monkeypatch.setattr(_lib, "on_cuda", lambda t: True)
    monkeypatch.setattr(kmod, kfn, kernel_spy)
    monkeypatch.setattr(rmod, rfn, plain_trap)
    with pytest.raises(_Reached):
        wrapper(*args, **kw)
    assert calls == [name]


@pytest.mark.parametrize("case", _wrappers(), ids=lambda c: c[0])
def test_cpu_tensors_take_the_plain_version(monkeypatch, case):
    name, wrapper, args, kw, kmod, kfn, rmod, rfn = case

    def kernel_trap(*a, **k):
        raise AssertionError(f"{name}: CPU input reached the kernel")

    monkeypatch.setattr(kmod, kfn, kernel_trap)
    wrapper(*args, **kw)


def test_kernel_launcher_raises_without_a_build(monkeypatch, tmp_path):
    """A launcher never returns without its kernel: with no nvcc on the
    host it raises instead of computing anything."""
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_lib, "_libs", {})
    monkeypatch.setattr(_lib, "_fns", {})
    monkeypatch.setattr(_lib.shutil, "which", lambda name: None)
    monkeypatch.setattr(_lib, "Path", lambda p: tmp_path / "no-nvcc")
    x = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="nvcc"):
        td_kernel.frontier_compact_cuda(x, x.bool(), 2, scratch=0)


def test_library_name_follows_headers_and_flags(monkeypatch, tmp_path):
    """A kernel's library is named by a hash of its source, every shared
    ``csrc/*.cuh`` and its ``nvcc`` flags: editing a header, adding one or
    changing a flag names a new library, so a stale one is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "shared.cuh"\n')
    (csrc / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(_lib, "CSRC", csrc)
    names = [_lib._target("k")]
    assert _lib._target("k") == names[0]  # the same inputs, the same name
    (csrc / "shared.cuh").write_text("// v2\n")
    names.append(_lib._target("k"))
    (csrc / "other.cuh").write_text("// another header\n")
    names.append(_lib._target("k"))
    monkeypatch.setattr(_lib, "NVCC_FLAGS", _lib.NVCC_FLAGS + ("-I/usr/local/cutlass/include",))
    names.append(_lib._target("k"))
    assert len(set(names)) == len(names), names
    assert all(n.name.startswith("k-") and n.parent == _lib.BUILD_DIR for n in names)


def test_kernel_inputs_start_on_16_bytes():
    """The attention kernels read with 16-byte vector and TMA loads: a
    tensor whose data does not start on 16 bytes is copied first, one that
    does is passed through untouched."""
    base = torch.arange(40, dtype=torch.bfloat16)
    view = base[1:33]
    assert view.data_ptr() % 16 != 0
    fixed = _lib.aligned16(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)
    assert _lib.aligned16(base) is base


def test_gqa_decode_reaches_the_decode_kernel(monkeypatch):
    """The model's decode attention goes through the kernel wrapper: with
    every tensor reporting CUDA, ``gqa_decode`` calls the kernel launcher
    and never the plain version."""
    from repro_torch.models import attention
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.params import init_params

    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=128, n_heads=2, n_kv=1,
                      d_ff=8, vocab=8, dtype="float32")
    p = init_params(attention.gqa_spec(cfg), "cpu")
    cache = attention.KVCache(torch.zeros((1, 1, 4, 64)), torch.zeros((1, 1, 4, 64)))

    def kernel_spy(*a, **k):
        raise _Reached

    def plain_trap(*a, **k):
        raise AssertionError("gqa_decode: CUDA input reached the plain version")

    monkeypatch.setattr(_lib, "on_cuda", lambda t: True)
    monkeypatch.setattr(da_kernel, "decode_attention_cuda", kernel_spy)
    monkeypatch.setattr(da_ref, "decode_attention_ref", plain_trap)
    with pytest.raises(_Reached):
        attention.gqa_decode(p, torch.zeros((1, 1, 128)), cfg, cache, 2)


def test_cross_apply_decode_reaches_the_decode_kernel(monkeypatch):
    """Whisper's one-token cross-attention over the encoder output is the
    decode kernel's function at kv_len = the frames: with every tensor
    reporting CUDA, ``cross_apply`` of one query row calls the kernel
    launcher over all the frames and never a plain version."""
    from repro_torch.models import attention
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.params import init_params

    cfg = ModelConfig(name="t", family="audio", n_layers=1, d_model=128, n_heads=2, n_kv=2,
                      d_ff=8, vocab=8, dtype="float32", use_rope=False)
    p = init_params(attention.cross_spec(cfg), "cpu")
    seen = []

    def kernel_spy(q, k, v, kv_len, sm_scale):
        seen.append((tuple(q.shape), tuple(k.shape), k.is_contiguous(), kv_len))
        raise _Reached

    def plain_trap(*a, **k):
        raise AssertionError("cross_apply: CUDA input reached a plain version")

    monkeypatch.setattr(_lib, "on_cuda", lambda t: True)
    monkeypatch.setattr(da_kernel, "decode_attention_cuda", kernel_spy)
    monkeypatch.setattr(da_ref, "decode_attention_ref", plain_trap)
    monkeypatch.setattr(attention, "attention_ref", plain_trap)
    with pytest.raises(_Reached):
        attention.cross_apply(p, torch.zeros((3, 1, 128)), torch.zeros((3, 15, 128)), cfg)
    assert seen == [((3, 2, 64), (3, 2, 15, 64), True, 15)]


def test_gqa_train_reaches_the_flash_attention_kernel(monkeypatch):
    """The model's training attention goes through the kernel: with every
    tensor reporting CUDA, ``gqa_train`` calls the flash-attention launcher
    (inside the autograd Function) and never the plain version."""
    from repro_torch.models import attention
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.params import init_params

    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=64, n_heads=2, n_kv=1,
                      d_ff=8, vocab=8, dtype="float32")
    p = init_params(attention.gqa_spec(cfg), "cpu")
    seen = []

    def kernel_spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), kw))
        raise _Reached

    def plain_trap(*a, **k):
        raise AssertionError("gqa_train: CUDA input reached the plain version")

    monkeypatch.setattr(_lib, "on_cuda", lambda t: True)
    monkeypatch.setattr(fa_kernel, "flash_attention_cuda", kernel_spy)
    monkeypatch.setattr(fa_ref, "attention_ref", plain_trap)
    with pytest.raises(_Reached):
        attention.gqa_train(p, torch.zeros((3, 5, 64)), cfg)
    assert seen == [((3, 2, 5, 32), (3, 1, 5, 32),
                     dict(causal=True, window=0, sm_scale=1.0 / 32**0.5))]


def test_flash_attention_backward_is_the_plain_versions_autograd(monkeypatch):
    """The CUDA path's backward recomputes through the plain version and
    launches no kernel: with the forward launcher standing in for the
    kernel, the Function's grads equal plain autograd's bit for bit."""
    launches = []

    def fake_kernel(q, k, v, **kw):
        launches.append(1)
        return fa_ref.attention_ref(q, k, v, **kw)

    monkeypatch.setattr(_lib, "on_cuda", lambda t: True)
    monkeypatch.setattr(fa_kernel, "flash_attention_cuda", fake_kernel)
    gen = torch.Generator().manual_seed(0)
    q, k, v, w = (torch.randn(s, generator=gen) for s in
                  ((2, 4, 33, 32), (2, 2, 33, 32), (2, 2, 33, 32), (2, 4, 33, 32)))
    grads = []
    for fn in (fa_ops.flash_attention, lambda *a: fa_ref.attention_ref(*a[:3], causal=True)):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        (fn(*xs) * w).sum().backward()
        grads.append([x.grad for x in xs])
    assert launches == [1]
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["decode_attention", "flash_attention"])
def test_dtensor_inputs_reach_the_kernel_as_local_tensors(monkeypatch, name):
    """Under a mesh the attention wrappers get ``DTensor`` s: with every
    tensor reporting CUDA, the wrapper runs again on each rank's local
    shard, and the kernel launcher gets plain tensors, never a ``DTensor``;
    the plain version is never called."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh, shutdown

    _, wrapper, args, kw, kmod, kfn, rmod, rfn = next(c for c in _wrappers() if c[0] == name)
    seen = []

    def kernel_spy(*a, **k):
        seen.append([type(x) for x in a if isinstance(x, torch.Tensor)])
        raise _Reached

    def plain_trap(*a, **k):
        raise AssertionError(f"{name}: a DTensor input reached the plain version")

    monkeypatch.setattr(_lib, "on_cuda", lambda t: True)
    monkeypatch.setattr(kmod, kfn, kernel_spy)
    monkeypatch.setattr(rmod, rfn, plain_trap)
    try:
        mesh = make_host_mesh("cpu")
        placed = [distribute_tensor(a, mesh, [Shard(0), Replicate()])
                  if isinstance(a, torch.Tensor) else a for a in args]
        assert all(isinstance(a, DTensor) for a in placed[:3])
        with pytest.raises(_Reached):
            wrapper(*placed, **kw)
    finally:
        shutdown()
    assert seen == [[torch.Tensor] * 3]
