"""The port's depth-probe correction (``repro_torch.analysis.scan_correction``)
against the JAX package's.

``_probe_plan`` must give JAX's probes, counts and full counts for every
arch, with and without its optimized overrides.  JAX's plans come from a
subprocess: importing ``repro.analysis.scan_correction`` sets ``XLA_FLAGS``
for 512 host devices, which must never happen inside a test worker.

The port counts every layer, so the correction is a check that the
dry-run counts linearly in depth: ``correct_cell`` probes 1-3 layers and
must predict a trace at a depth it did not probe (qwen2 at 3 layers,
deepseek at one dense and three MoE layers, zamba2 at six mamba layers and
two shared-block invocations, xlstm at four mLSTM and two sLSTM layers),
FLOPs, argument bytes and collective bytes exactly (the probe systems are
square: the fit's residual is zero by construction).  The same two
subprocesses trace qwen2's decode cell at full depth, one first thing
under ``PYTHONHASHSEED=1``, one twice after its other traces under
``PYTHONHASHSEED=2``: every count must be equal (the dry-run's caches are
emptied before each trace).  The fake world is process-wide, so every
trace runs in a subprocess (``probes``)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import scan_correction  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.optimized import OPTIMIZED  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
# the collective bytes' tolerance: the counts are bit-equal across
# processes, hash seeds and repeated traces (PERF.md §6, the dry-run's counts)
COLLECTIVE_TOL_BYTES = 0
FULL_CELL = ("qwen2-0.5b", "decode_32k", "multi")
CASES = {
    "qwen2": ("qwen2-0.5b", "decode_32k", "multi", {"n_layers": 3}),
    "xlstm": ("xlstm-350m", "long_500k", "single", {"n_layers": 6, "slstm_every": 3}),
    "deepseek": ("deepseek-v3-671b", "decode_32k", "multi",
                 {"param_dtype": "bfloat16", "first_k_dense": 1, "n_layers": 4}),
    "zamba2": ("zamba2-1.2b", "decode_32k", "single", {"n_layers": 6, "shared_attn_every": 3}),
}
# (hash seed, the full cell first?, cases) of each subprocess
JOBS = [(1, True, ["qwen2", "xlstm", "zamba2"]), (2, False, ["deepseek"])]

_PROBES = """
import json, sys
from repro_torch.analysis.scan_correction import correct_cell
from repro_torch.launch.dryrun import run_cell
full_first, cases, full = json.loads(sys.argv[1])

def full_cell():
    rec = run_cell(*full)
    print("FULL=" + json.dumps({k: rec[k] for k in ("cost", "memory", "collectives")}), flush=True)

if full_first:
    full_cell()
for name, (arch, shape, mesh, ov) in cases.items():
    corr = correct_cell(arch, shape, mesh, overrides=ov)
    rec = run_cell(arch, shape, mesh, overrides=ov)
    print("CASE=" + json.dumps({"name": name, "corr": corr, "rec": rec}), flush=True)
if not full_first:  # twice: the second trace meets the caches the first filled
    full_cell()
    full_cell()
"""

_JAX_PLANS = """
import json
from repro.analysis.scan_correction import _probe_plan
from repro.configs import ARCH_IDS, get_config
from repro.configs.optimized import OPTIMIZED
plans = {}
for arch in ARCH_IDS:
    plans[arch] = _probe_plan(get_config(arch))
for (arch, shape), ov in OPTIMIZED.items():
    ov = dict(ov)
    ov.pop("param_dtype", None)
    plans[f"{arch}|{shape}"] = _probe_plan(get_config(arch).replace(**ov))
print("PLANS=" + json.dumps(plans))
"""


def _env(seed=None):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    if seed is not None:
        env["PYTHONHASHSEED"] = str(seed)
    return env


@pytest.fixture(scope="module")
def probes():
    procs = []
    for seed, full_first, names in JOBS:
        arg = json.dumps([full_first, {n: CASES[n] for n in names}, FULL_CELL])
        procs.append(subprocess.Popen([sys.executable, "-c", _PROBES, arg], env=_env(seed),
                                      cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    cases, fulls = {}, []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-4000:]
            for line in out.splitlines():
                if line.startswith("CASE="):
                    case = json.loads(line[5:])
                    cases[case["name"]] = case
                elif line.startswith("FULL="):
                    fulls.append(json.loads(line[5:]))
    finally:
        for p in procs:
            p.kill()
    return cases, fulls


@pytest.fixture(scope="module")
def jax_plans():
    env = {**_env(), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _JAX_PLANS], capture_output=True, text=True,
                          timeout=TIMEOUT_S, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("PLANS="))
    return json.loads(line[6:])


def _plan(cfg):
    return json.loads(json.dumps(scan_correction._probe_plan(cfg)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_probe_plan_equals_jaxs(jax_plans, arch):
    assert _plan(get_config(arch)) == jax_plans[arch]


@pytest.mark.parametrize("cell", sorted(OPTIMIZED), ids=lambda c: "-".join(c))
def test_probe_plan_equals_jaxs_with_the_opt_overrides(jax_plans, cell):
    ov = dict(OPTIMIZED[cell])
    ov.pop("param_dtype", None)
    assert _plan(get_config(cell[0]).replace(**ov)) == jax_plans["|".join(cell)]


@pytest.mark.parametrize("name", list(CASES))
def test_correction_predicts_a_depth_it_did_not_probe(probes, name):
    cases, _ = probes
    corr, rec = cases[name]["corr"], cases[name]["rec"]
    _, _, _, ov = CASES[name]
    assert corr["corrected"] and rec["status"] == "run"
    cfg = get_config(CASES[name][0]).replace(**{k: v for k, v in ov.items() if k != "param_dtype"})
    probed = scan_correction._probe_plan(cfg)[0]
    assert {k: ov[k] for k in probed[0]} not in probed  # the traced depth was not probed
    assert round(corr["flops"]) == rec["cost"]["flops"]
    assert round(corr["bytes_accessed"]) == rec["cost"]["bytes_accessed"]
    assert abs(corr["collective_bytes"] - rec["collectives"]["total_bytes"]) <= \
        COLLECTIVE_TOL_BYTES + 0.5
    assert len(corr["probe_s"]) == len(probed)


def test_counts_equal_across_processes_hash_seeds_and_repeated_traces(probes):
    """qwen2's decode cell traced first thing in a process under one hash
    seed, and twice after four traces of another cell in another process
    under another, counts the same FLOPs, bytes, collectives and temp."""
    _, fulls = probes
    assert len(fulls) == 3
    assert fulls[0] == fulls[1] == fulls[2]
    assert fulls[0]["collectives"]["total_bytes"] > 0


def test_whisper_is_unrolled_already():
    assert scan_correction.correct_cell("whisper-tiny", "train_4k", "single") == {
        "corrected": False, "reason": "unrolled already"}
