"""The port's dry-run report (``repro_torch.analysis.report``) against the JAX
package's (``repro.analysis.report``) on the same hand-built records: run
and skip cells on both meshes, with and without a depth-probe correction.
``dryrun_table`` and ``corrected_record`` are pure formatting and overlay,
so they must give JAX's text and dicts; the roofline terms are the port's
own, each the record's count over the NVIDIA H100's constants."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import report as jreport  # noqa: E402

from repro_torch.analysis import report, roofline  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# NVIDIA H100 80GB HBM3 (SXM, 700 W): bf16 tensor-core peak, HBM, NVLink one way
H100 = {"PEAK_FLOPS": 989e12, "HBM_BW": 3.35e12, "NVLINK_BW": 450e9}


def _run(arch, shape, mesh, flops, nbytes, coll, n_params=1.0e9, secs=2.5):
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": "run", "n_params": n_params,
            "cost": {"flops": flops, "bytes_accessed": nbytes},
            "collectives": {"per_op_bytes": {"all-gather": coll}, "total_bytes": coll},
            "n_devices": 512 if mesh == "multi" else 256, "lower_compile_s": secs}


def _skip(arch, shape, mesh):
    return {"arch": arch, "shape": shape, "mesh": mesh,
            "status": "skip: pure full-attention arch (long_500k needs sub-quadratic)"}


RECORDS = {f"{r['arch']}|{r['shape']}|{r['mesh']}": r for r in [
    _run("qwen2-0.5b", "decode_32k", "single", 1.1275e10, 4.9e8, 1.37e8, 4.94e8, 8.9),
    _run("qwen2-0.5b", "decode_32k", "multi", 1.1275e10, 4.9e8, 1.37e8, 4.94e8, 7.6),
    _run("qwen2-0.5b", "train_4k", "single", 7.168e12, 8.67e8, 5.04e10, 4.94e8, 6.2),
    _run("deepseek-v3-671b", "decode_32k", "multi", 5.75e11, 6.9e9, 6.0e9, 6.7e11, 12.1),
    _run("xlstm-350m", "long_500k", "single", 2.713e8, 4.9e8, 1.81e7, 3.5e8, 1.2),
    _run("xlstm-350m", "train_4k", "single", 1.0, 3.0e8, 0.0, 3.5e8, 0.0),
    _run("whisper-tiny", "train_4k", "single", 1.207e12, 3.5e8, 9.87e8, 3.9e7, 4.3),
    _run("zamba2-1.2b", "prefill_32k", "single", 9.9e13, 2.0e9, 3.0e3, 1.2e9, 3.1),
    _skip("yi-9b", "long_500k", "single"),
    _skip("qwen2-0.5b", "long_500k", "multi"),
]}
CORRECTIONS = {
    "xlstm-350m|train_4k|single": {"corrected": True, "flops": 9.5e12, "bytes_accessed": 3.1e9,
                                   "collective_bytes": 4.4e9, "per_stack_flops": [1.0, 2.0],
                                   "full_counts": [20, 4]},
    "qwen2-0.5b|decode_32k|single": {"corrected": False, "reason": "unrolled already"},
    "whisper-tiny|train_4k|single": {"corrected": False, "error": "RuntimeError: cut"},
}


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dryrun_table_is_jaxs_text(mesh):
    assert report.dryrun_table(RECORDS, mesh) == jreport.dryrun_table(RECORDS, mesh)


@pytest.mark.parametrize("cid", sorted(c for c, r in RECORDS.items() if r["status"] == "run"),
                         ids=lambda c: c.replace("|", "-"))
def test_corrected_record_equals_jaxs(cid):
    rec = RECORDS[cid]
    for corr in (CORRECTIONS, {}):
        assert report.corrected_record(rec, corr) == jreport.corrected_record(rec, corr)


def test_formatters_equal_jaxs():
    values = [0.0, 1e-9, 3e-7, 9.99e-4, 1e-3, 0.0123, 0.999, 1.0, 59.9, 3600.0]
    for x in values:
        assert report._fmt_t(x) == jreport._fmt_t(x)
    sizes = [0, 1, 1023, 1024, 1536.5, 2**20, 7.3e9, 2**40 - 1, 2**40, 3.2e15, 9e18, -4096]
    for x in sizes:
        assert report._fmt_b(x) == jreport._fmt_b(x)


def test_constants_are_the_h100s():
    for name, value in H100.items():
        assert getattr(roofline, name) == value


def _rows(text):
    return [[c.strip() for c in line.strip("|").split("|")] for line in text.splitlines()[2:]]


@pytest.mark.parametrize("corrections", [{}, CORRECTIONS], ids=["plain", "corrected"])
@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_roofline_table_terms_are_the_record_over_the_h100(mesh, corrections):
    from repro_torch.configs import SHAPES, get_config

    text = report.roofline_table(RECORDS, mesh, corrections)
    assert text.splitlines()[0].split("|")[7].strip() == "MODEL/counted"
    rows = _rows(text)
    runs = sorted((cid, r) for cid, r in RECORDS.items()
                  if r["mesh"] == mesh and r["status"] == "run")
    assert [row[:2] for row in rows] == [[r["arch"], r["shape"]] for _, r in runs]
    for row, (cid, rec) in zip(rows, runs):
        c = corrections.get(cid, {})
        fixed = c.get("corrected", False)
        flops = c["flops"] if fixed else rec["cost"]["flops"]
        nbytes = c["bytes_accessed"] if fixed else rec["cost"]["bytes_accessed"]
        coll = c["collective_bytes"] if fixed else rec["collectives"]["total_bytes"]
        terms = {"compute": flops / H100["PEAK_FLOPS"], "memory": nbytes / H100["HBM_BW"],
                 "collective": coll / H100["NVLINK_BW"]}
        assert row[2:5] == [report._fmt_t(terms[k]) for k in ("compute", "memory", "collective")]
        assert row[5] == f"**{max(terms, key=terms.get)}**"
        mf = roofline.model_flops(get_config(rec["arch"]), SHAPES[rec["shape"]])
        assert row[6] == f"{mf / (flops * rec['n_devices']):.2f}"
        assert row[7] == ("✓" if fixed else "–")
        hint = report.improvement_hint(get_config(rec["arch"]), SHAPES[rec["shape"]],
                                       max(terms, key=terms.get))
        assert row[8] == hint


@pytest.mark.parametrize("corrections", [{}, CORRECTIONS], ids=["plain", "corrected"])
def test_summary_terms_are_the_record_over_the_h100(monkeypatch, corrections):
    from repro_torch.configs import SHAPES, get_config

    monkeypatch.setattr(report, "load_corrections", lambda *a, **k: corrections)
    out = report.summary(RECORDS)
    singles = {cid for cid, r in RECORDS.items() if r["mesh"] == "single" and r["status"] == "run"}
    assert set(out) == singles
    for cid in singles:
        rec = report.corrected_record(RECORDS[cid], corrections)
        s = out[cid]
        assert s["t_compute_s"] == rec["cost"]["flops"] / H100["PEAK_FLOPS"]
        assert s["t_memory_s"] == rec["cost"]["bytes_accessed"] / H100["HBM_BW"]
        assert s["t_collective_s"] == rec["collectives"]["total_bytes"] / H100["NVLINK_BW"]
        terms = {k: s[f"t_{k}_s"] for k in ("compute", "memory", "collective")}
        assert s["dominant"] == max(terms, key=terms.get)
        assert s["roofline_fraction"] == s["t_compute_s"] / max(terms.values())
        assert s["model_flops"] == roofline.model_flops(get_config(rec["arch"]),
                                                        SHAPES[rec["shape"]])
        assert s["chips"] == rec["n_devices"]


def test_hint_rules_are_jaxs():
    """The same rule picks the hint (collective / memory at decode / memory
    / compute); the words speak of the card."""
    from repro_torch.configs import SHAPES, get_config

    cfg = get_config("qwen2-0.5b")
    hints = {(shape, dom): report.improvement_hint(cfg, SHAPES[shape], dom)
             for shape in ("decode_32k", "train_4k") for dom in ("collective", "memory", "compute")}
    assert hints[("decode_32k", "collective")] == hints[("train_4k", "collective")]
    assert hints[("decode_32k", "compute")] == hints[("train_4k", "compute")]
    assert len(set(hints.values())) == 4
    assert "HBM" in hints[("decode_32k", "memory")] and "tensor-core" in hints[("train_4k", "compute")]
    assert "NVLink" in hints[("train_4k", "collective")]
    assert not any(w in h for h in hints.values() for w in ("MXU", "ICI", "TPU"))


def test_cli_renders_a_results_file(tmp_path):
    path = tmp_path / "dryrun_torch.json"
    path.write_text(json.dumps(RECORDS))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis.report", str(path)],
                          capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "## §Dry-run (single-pod 16×16 = 256 ranks of a fake world)" in out
    assert "## §Dry-run (multi-pod 2×16×16 = 512 ranks of a fake world)" in out
    assert report.dryrun_table(RECORDS, "single") in out
    assert report.dryrun_table(RECORDS, "multi") in out
    roof = out[out.index("## §Roofline"):]
    assert len(_rows(roof.split("\n", 2)[2])) == sum(
        1 for r in RECORDS.values() if r["mesh"] == "single" and r["status"] == "run")
