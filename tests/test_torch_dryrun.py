"""The port's dry-run (``repro_torch.launch.dryrun``) on a fake world of 256
/ 512 ranks, over JAX's integration cells (``tests/test_dryrun_integration.py``):
``whisper-tiny train_4k single`` (a train step, encoder-decoder),
``qwen2-0.5b decode_32k multi`` (a serve step on the multi-pod mesh) and
``xlstm-350m long_500k single`` (an ssm long-context decode) run, with
FLOPs and argument bytes counted (the decode's temp bytes its step's own,
so it fits one card), and ``yi-9b long_500k single`` is a skip.
The fake world is a process-wide default group, so the cells run in one
subprocess a module (``cells``), never in a test worker.  ``input_specs``
gives meta tensors of the shapes and dtypes of JAX's ``ShapeDtypeStruct`` s.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
RUN = [("whisper-tiny", "train_4k", "single"), ("qwen2-0.5b", "decode_32k", "multi"),
       ("xlstm-350m", "long_500k", "single")]
SKIP = [("yi-9b", "long_500k", "single")]
CELLS_TIMEOUT_S = 240

_SCRIPT = """
import json, sys
from repro_torch.launch.dryrun import run_cell
for arch, shape, mesh in json.loads(sys.argv[1]):
    print("REC=" + json.dumps(run_cell(arch, shape, mesh)), flush=True)
"""


@pytest.fixture(scope="module")
def cells():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, json.dumps(RUN + SKIP)],
                          capture_output=True, text=True, timeout=CELLS_TIMEOUT_S, env=env,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    recs = [json.loads(line[4:]) for line in proc.stdout.splitlines() if line.startswith("REC=")]
    return {(r["arch"], r["shape"], r["mesh"]): r for r in recs}


@pytest.mark.parametrize("cell", RUN, ids=lambda c: "-".join(c))
def test_dryrun_cell_runs(cells, cell):
    rec = cells[cell]
    assert rec["status"] == "run"
    assert rec["cost"]["flops"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["n_devices"] == (512 if cell[2] == "multi" else 256)
    assert rec["collectives"]["total_bytes"] == sum(rec["collectives"]["per_op_bytes"].values())
    assert rec["fits"] == (rec["memory"]["argument_size_in_bytes"]
                           + rec["memory"]["temp_size_in_bytes"] <= 80e9)
    if cell[1] == "decode_32k":
        # temp is the step's own: the global meta cache is made before the
        # trackers open (1.5e9 measured, the whole cache 5.2e10)
        assert rec["fits"] and rec["memory"]["temp_size_in_bytes"] < 4e9


def test_dryrun_skip_rule(cells):
    assert cells[SKIP[0]]["status"].startswith("skip")


@pytest.mark.parametrize("cell", [("whisper-tiny", "train_4k"), ("internvl2-2b", "prefill_32k"),
                                  ("deepseek-v3-671b", "decode_32k"), ("zamba2-1.2b", "long_500k")],
                         ids=lambda c: "-".join(c))
def test_input_specs_are_meta_tensors_of_jax_shapes(cell):
    import repro.core  # noqa: F401  (x64)
    import jax
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.launch.inputs import input_specs as jinput_specs

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.inputs import input_specs

    arch, shape = cell
    want = jinput_specs(jget(arch), JSHAPES[shape])
    got = input_specs(get_config(arch), SHAPES[shape])
    jl = {jax.tree_util.keystr(k): (tuple(v.shape), np.dtype(v.dtype).name)
          for k, v in jax.tree_util.tree_leaves_with_path(want)}
    tl = {}
    for k, v in torch.utils._pytree.tree_leaves_with_path(got):
        if v is not None:
            assert v.is_meta
            tl[torch.utils._pytree.keystr(k)] = (tuple(v.shape), str(v.dtype).removeprefix("torch."))
    assert tl == jl and jl


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
def test_roofline_counts_equal_jax(shape):
    """``active_params``, ``model_flops`` and ``analytic_memory_bytes``
    equal JAX's for every arch; ``roofline_terms`` reads one device's
    counts against the H100's peaks."""
    import repro.core  # noqa: F401
    from repro.analysis import roofline as jroofline
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget

    from repro_torch.analysis import roofline
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config

    for arch in ARCH_IDS:
        jc, tc = jget(arch), get_config(arch)
        assert roofline.active_params(tc) == jroofline.active_params(jc), arch
        assert roofline.model_flops(tc, SHAPES[shape]) == jroofline.model_flops(jc, JSHAPES[shape])
        assert roofline.analytic_memory_bytes(tc, SHAPES[shape]) == \
            jroofline.analytic_memory_bytes(jc, JSHAPES[shape])
    rec = {"n_devices": 256, "cost": {"flops": 989e12, "bytes_accessed": 6.7e12},
           "collectives": roofline.collective_bytes([("all-gather", 450e9), ("all-reduce", 450e9)])}
    terms = roofline.roofline_terms(rec)
    assert rec["collectives"]["total_bytes"] == 900e9
    assert (terms["t_compute_s"], terms["t_memory_s"], terms["t_collective_s"]) == (1.0, 2.0, 2.0)
    assert terms["dominant"] == "memory" and terms["chips"] == 256
