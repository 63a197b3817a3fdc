"""Boundary of the port: ``src/repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package; the tree refuses to drop to the CPU on its
own; and every kernel wrapper sends a CUDA tensor to its kernel, never to
the plain version."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ABTree, TreeConfig  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.elim_combine import kernel as ec_kernel, ops as ec_ops, ref as ec_ref  # noqa: E402
from repro_torch.kernels.range_scan import kernel as rs_kernel, ops as rs_ops, ref as rs_ref  # noqa: E402
from repro_torch.kernels.tree_descend import kernel as td_kernel, ops as td_ops, ref as td_ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
    assert {"abtree.py", "rounds.py", "elimination.py", "chip_smoke.py", "_lib.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = {r for r in _imported_roots(path) if r in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_tree_without_device_raises_on_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ABTree(TreeConfig(capacity=64, b=8, a=2, max_height=8))


def test_occ_mode_names_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ABTree(TreeConfig(capacity=64, b=8, a=2, max_height=8), mode="occ", device="cpu")


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
        td_kernel.frontier_compact_cuda(x, x.bool(), 2)
