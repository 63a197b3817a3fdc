"""Public forms of the JAX package that the port gained last, held to JAX's
on the CPU:

* the core's bare-state ``descend``, ``probe`` and ``frontier_expand``
  (``src/repro/core/abtree.py``) on trees both packages built from the
  same rounds (``prefill_tree`` at ``WorkloadConfig(key_range=600)``, then
  a round deleting half of the keys): leaf ids, found, slot and value of
  hits, misses and EMPTY (NOP) lanes, and the five outputs of the frontier
  expansion (leaves, candidate keys and values, the touched read set, the
  overflow flags) at caps that overflow and caps that fit, bit-equal;
* ``Tracer.counter`` and ``Tracer.clear``: the same events as JAX's tracer
  but for ``ts`` / ``dur``, nothing recorded when disabled, the clock
  restarted by ``clear``, and the exported document equal to JAX's
  ``to_chrome_trace`` of the same events, valid under both packages'
  ``validate_trace``;
* ``models.params.abstract_params``: every arch of the registry's spec tree
  as meta tensors of JAX's ``ShapeDtypeStruct`` shapes and dtypes;
* and that every public name of ``src/repro/`` (module-level names, class
  methods and attributes, a package's imports) has a counterpart in
  ``src/repro_torch/``: the same name in the same module, a Pallas
  kernel's CUDA entry point, or one of the counterparts ``RENAMED`` lists;
  the only names left out are the TPU's (``ROADMAP.md``, "JAX-only").
"""
import json
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402  (enables jax x64 before any JAX input is built)
import jax.numpy as jnp  # noqa: E402
from repro.core import abtree as jabtree  # noqa: E402
from repro.data import workloads as jw  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.core import abtree as tabtree  # noqa: E402
from repro_torch.data import workloads as tw  # noqa: E402
from test_torch_rounds import CFG, KEY_RANGE, _pool_diff  # noqa: E402

EMPTY = int(J.EMPTY)


@pytest.fixture(scope="module")
def trees():
    """A JAX tree and a port tree from the same rounds, and the live keys."""
    jt, tt = J.ABTree(J.TreeConfig(**CFG)), T.ABTree(T.TreeConfig(**CFG), device="cpu")
    jw.prefill_tree(jt, jw.WorkloadConfig(key_range=KEY_RANGE))
    tw.prefill_tree(tt, tw.WorkloadConfig(key_range=KEY_RANGE))
    keys = np.asarray(sorted(tt.items()), np.int64)
    rng = np.random.default_rng(4)
    drop = rng.choice(keys, size=keys.size // 2, replace=False)
    ops = np.full(keys.size, J.OP_FIND, np.int32)
    ops[: drop.size] = J.OP_DELETE
    batch = np.concatenate([drop, rng.choice(keys, size=keys.size - drop.size)])
    for t in (jt, tt):
        t.apply_round(ops, batch, np.zeros_like(batch))
    assert _pool_diff(jt, tt) == [] and jt.items() == tt.items()
    assert int(tt.state.height) >= 2  # routers to descend through
    return jt, tt, np.setdiff1d(keys, drop)


def _point_queries(live, bsz, seed):
    rng = np.random.default_rng(seed)
    q = rng.choice(live, size=bsz).astype(np.int64)
    q[1::3] = rng.integers(0, 2 * KEY_RANGE, q[1::3].size)  # misses, some past the range
    q[0] = EMPTY  # a NOP lane: every router counted, child b-1
    return q


@pytest.mark.parametrize("bsz", [1, 9, 300])
def test_descend_and_probe_equal_jax(trees, bsz):
    jt, tt, live = trees
    q = _point_queries(live, bsz, bsz)
    jleaf = jabtree.descend(jt.state, jnp.asarray(q), jt.cfg)
    jfound, jslot, jval = jabtree.probe(jt.state, jleaf, jnp.asarray(q))
    leaf = tabtree.descend(tt.state, torch.as_tensor(q), tt.cfg)
    found, slot, val = tabtree.probe(tt.state, leaf, torch.as_tensor(q))
    for got, want, name in ((leaf, jleaf, "leaf"), (found, jfound, "found"),
                            (slot, jslot, "slot"), (val, jval, "val")):
        w = np.asarray(want)
        assert got.numpy().dtype == w.dtype and np.array_equal(got.numpy(), w), name
    # the same answers as the fused search the round engine runs (K1's plain version)
    from repro_torch.kernels.tree_descend import descend_probe

    st = tt.stacked
    k1 = descend_probe(st.keys, st.vals, st.children, st.is_leaf, st.root,
                       torch.as_tensor(q)[None], max_height=tt.cfg.max_height,
                       notfound=int(J.NOTFOUND))
    for got, want in zip((leaf, found, slot, val), k1):
        assert torch.equal(got, want[0])


def _intervals(bsz, seed):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, KEY_RANGE, bsz).astype(np.int64)
    hi = lo + rng.integers(1, KEY_RANGE, bsz)
    lo[0], hi[0] = 0, EMPTY  # the whole key range
    if bsz > 2:
        lo[1], hi[1] = EMPTY, EMPTY  # a padding lane
        hi[2] = lo[2]  # an empty interval
    return lo, hi


@pytest.mark.parametrize("cap", [2, 8, 64])
def test_frontier_expand_equals_jax(trees, cap):
    """All five outputs bit-equal; cap 2 overflows on the wide intervals
    and cap 64 holds every frontier."""
    jt, tt, _ = trees
    lo, hi = _intervals(33, cap)
    want = jabtree.frontier_expand(jt.state, jt.cfg, jnp.asarray(lo), jnp.asarray(hi), cap)
    got = tabtree.frontier_expand(tt.state, tt.cfg, torch.as_tensor(lo), torch.as_tensor(hi), cap)
    names = ("leaves", "cand_keys", "cand_vals", "touched", "overflow")
    for g, w, name in zip(got, want, names):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g.numpy(), w), name
    overflow = got[4].numpy()
    if cap == 2:
        assert overflow.any()
    if cap == 64:
        assert not overflow.any()
    # the flat form over the stacked pool gives the same tuple
    flat = tabtree.frontier_expand_sharded(tt.stacked, tt.cfg, torch.zeros(33, dtype=torch.int32),
                                           torch.as_tensor(lo), torch.as_tensor(hi), cap)
    assert all(torch.equal(a, b) for a, b in zip(got, flat))


# -- Tracer.counter / clear ----------------------------------------------------


def _drive(tr):
    with tr.span("round", rows=3) as sp:
        sp.note(lanes=7)
    tr.instant("mark", shard=1, lanes=4)
    tr.counter("retry_passes", 3)
    tr.counter("retry_passes", 2.5, shard=0)
    tr.counter("live_keys", np.int64(300), shard=2)
    tr.shard_marks("apply", [0, 5, 2])


def _no_clock(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in events]


def test_tracer_counter_and_clear_equal_jax(tmp_path):
    from repro.obs import trace_export as jexport
    from repro.obs.tracer import Tracer as JTracer

    from repro_torch.obs import trace_export as texport
    from repro_torch.obs.tracer import Tracer

    tracers = {"jax": JTracer(pid=3), "port": Tracer(pid=3)}
    for name, tr in tracers.items():
        _drive(tr)
        tr.clear()
        assert tr.events == []
        time.sleep(0.02)
        t0, u0 = time.perf_counter(), time.time_ns() / 1e3
        tr.clear()
        _drive(tr)
        if name == "jax":  # the clock restarted at the second clear
            assert all(0 <= e["ts"] <= (time.perf_counter() - t0) * 1e6 for e in tr.events)
        else:  # the port stamps on the profiler's clock, Unix time in µs
            assert all(u0 <= e["ts"] <= time.time_ns() / 1e3 for e in tr.events)
    j, t = tracers["jax"], tracers["port"]
    assert _no_clock(t.events) == _no_clock(j.events)
    counters = [e for e in t.events if e["ph"] == "C"]
    assert [(e["tid"], e["args"]) for e in counters] == [
        (0, {"value": 3.0}), (1, {"value": 2.5}), (3, {"value": 300.0})]
    assert all(type(e["args"]["value"]) is float for e in counters)
    path = t.export(str(tmp_path / "trace.json"))
    doc = texport.load_trace(path)
    assert doc == json.loads(json.dumps(jexport.to_chrome_trace(t)))
    assert texport.validate_trace(doc) == jexport.validate_trace(doc) == []
    for off in (JTracer(enabled=False), Tracer(enabled=False)):
        off.counter("retry_passes", 1)
        assert off.events == []


# -- abstract_params -------------------------------------------------------------


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def test_abstract_params_equal_jax_for_every_arch():
    from repro.configs import ARCH_IDS as JARCHS, get_config as jget
    from repro.models import abstract_params as jabstract
    from repro.models.backbone import model_spec as jspec

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import abstract_params, count_params
    from repro_torch.models.backbone import model_spec

    assert list(ARCH_IDS) == list(JARCHS)
    for arch in ARCH_IDS:
        spec = model_spec(get_config(arch))
        got, want = _leaves(abstract_params(spec)), _leaves(jabstract(jspec(jget(arch))))
        assert [p for p, _ in got] == [p for p, _ in want], arch
        for (path, g), (_, w) in zip(got, want):
            assert g.device.type == "meta", (arch, path)
            assert tuple(g.shape) == tuple(w.shape), (arch, path)
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), (arch, path)
        assert sum(g.numel() for _, g in got) == count_params(spec), arch


# -- every public name of the JAX package has a counterpart ---------------------

SRC = Path(__file__).resolve().parents[1] / "src"
# JAX names whose counterpart in the port has another name or module, and
# the names the port declares JAX-only (None): HLO text and the TPU's link
# bandwidth, and the Pallas kernels' TPU constants (the int32 gate's
# sentinel and pool bound, the range scan's VMEM tile threshold, the
# attention kernels' mask value)
RENAMED = {
    ("obs/hlo_audit.py", "DEFAULT_OPS"): ("obs/op_audit.py", "DEFAULT_OPS"),
    ("obs/hlo_audit.py", "assert_no_sort"): ("obs/op_audit.py", "assert_no_sort"),
    ("obs/hlo_audit.py", "audit_search_phases"): ("obs/op_audit.py", "audit_search_phases"),
    ("obs/hlo_audit.py", "count_ops"): ("obs/op_audit.py", "count_ops"),
    ("obs/hlo_audit.py", "lower_text"): ("obs/op_audit.py", "profile_ops"),
    ("analysis/roofline.py", "ICI_BW"): ("analysis/roofline.py", "NVLINK_BW"),
    ("analysis/roofline.py", "collective_bytes_from_hlo"):
        ("analysis/roofline.py", "CollectiveRecorder"),
}
TPU_CONSTANTS = {"INT32_MAX", "TILE_AUTO_THRESHOLD", "MAX_POOL_ROWS", "NEG_INF"}
# the TPU's kernel gates: the int32 ``narrow`` paths of the trees and the
# models' Pallas switch (the port picks the kernel by the tensor's device)
TPU_GATES = {"ABTree.narrow", "ABTree.narrow_scan", "ABForest.narrow", "ABForest.narrow_scan",
             "ModelConfig.use_pallas"}


def _public_names(path):
    """Module-level public names of ``path``, the public methods of its
    classes and the attributes their methods set (``Class.name``); an
    ``__init__.py`` also counts what it imports."""
    import ast

    tree = ast.parse(path.read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        if isinstance(node, ast.ClassDef):
            for sub in ast.walk(node):
                if isinstance(sub, ast.FunctionDef):
                    out.add(f"{node.name}.{sub.name}")
                elif (isinstance(sub, ast.Attribute) and isinstance(sub.ctx, ast.Store)
                      and isinstance(sub.value, ast.Name) and sub.value.id == "self"):
                    out.add(f"{node.name}.{sub.attr}")
                elif isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name):
                    out.add(f"{node.name}.{sub.target.id}")
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign) else [])
        out |= {t.id for t in targets if isinstance(t, ast.Name)}
        if isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            out |= {a.asname or a.name for a in node.names}
    return {n for n in out if not n.split(".")[-1].startswith("_")}


def test_every_public_jax_name_has_a_port_counterpart():
    missing = []
    for path in sorted((SRC / "repro").rglob("*.py")):
        rel = path.relative_to(SRC / "repro").as_posix()
        for name in sorted(_public_names(path)):
            if name in TPU_CONSTANTS | TPU_GATES:
                continue
            if name.endswith("_pallas"):  # a Pallas kernel: its CUDA kernel's entry point
                mod, want = rel.rsplit("/", 1)[0] + "/kernel.py", name[: -len("_pallas")] + "_cuda"
            else:
                mod, want = RENAMED.get((rel, name), (rel, name))
            port = SRC / "repro_torch" / mod
            if not port.exists() or want not in _public_names(port):
                missing.append(f"{rel}:{name}")
    assert missing == []
