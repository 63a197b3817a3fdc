"""The port's four examples (``examples/*_torch.py``) run with ``--device
cpu`` and reach their end, each in a subprocess.  ``quickstart_torch.py``,
``durable_store_torch.py`` and ``serve_engine_torch.py`` print what their
JAX twins print (the JAX examples run in subprocesses too): every line but
the LM loss (the two packages draw other random weights), the serve
engine's stats with the same keys and every integer equal (the index's
slot writes, searches, rounds and eliminations; cache hits, admissions,
decode tokens, session scans), its times aside.  ``train_lm_torch.py``
crashes at ``--fail-at``, resumes from its checkpoint and ends with the
losses of an uninterrupted run; the JAX ``train_lm.py`` dies in its
Trainer's mesh path (as ``tests/test_infra.py::test_trainer_crash_restart_resume``
does), so the port's train example is held to itself."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TIMEOUT_S = 300
TWINS = ("quickstart", "durable_store", "serve_engine")
TRAIN = ["--steps", "10", "--batch", "4", "--seq", "64"]
FAIL_AT = 6  # checkpoints every 5 steps: the resume starts at step 5


def _env(tmp, jax=False):
    # the examples' temporary directories (the JAX ones keep theirs) under tmp
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           "TMPDIR": str(tmp)}
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    return env


def _start(script, args, cwd, jax=False):
    return subprocess.Popen([sys.executable, str(EXAMPLES / script), *args], env=_env(cwd, jax),
                            cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        proc.kill()
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run at once: the JAX twins, the port's three, and the train
    example uninterrupted beside its crash, then its resume."""
    tmp = tmp_path_factory.mktemp("examples")
    ck_full, ck_crash = tmp / "ck_full", tmp / "ck_crash"
    procs = {f"jax_{n}": _start(f"{n}.py", [], tmp, jax=True) for n in TWINS}
    procs.update({n: _start(f"{n}_torch.py", ["--device", "cpu"], tmp) for n in TWINS})
    procs["train_full"] = _start("train_lm_torch.py", TRAIN + ["--device", "cpu", "--ckpt",
                                                               str(ck_full)], tmp)
    crash = _start("train_lm_torch.py", TRAIN + ["--device", "cpu", "--ckpt", str(ck_crash),
                                                 "--fail-at", str(FAIL_AT)], tmp)
    out = {"train_crash": _finish(crash)}
    procs["train_resume"] = _start("train_lm_torch.py", TRAIN + ["--device", "cpu", "--ckpt",
                                                                 str(ck_crash)], tmp)
    for name, proc in procs.items():
        out[name] = _finish(proc)
    return out


def _ok(runs, name):
    rc, out, err = runs[name]
    assert rc == 0, f"{name}: exit {rc}\n{err[-3000:]}"
    return out


def _json_tail(text):
    return json.loads(text[text.index("{"):])


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}"))
        return out
    return {path: tree}


@pytest.mark.parametrize("name", ["quickstart", "durable_store"])
def test_example_prints_what_its_jax_twin_prints(runs, name):
    mine, theirs = (_ok(runs, n).splitlines() for n in (name, f"jax_{name}"))
    assert len(mine) == len(theirs) >= 4
    for a, b in zip(mine, theirs):
        if "initial loss" in b:  # other random weights: a float of its own
            assert a.split(":")[0] == b.split(":")[0]
            continue
        assert a == b


def test_serve_example_counts_equal_jaxs(runs):
    mine, theirs = _ok(runs, "serve_engine"), _ok(runs, "jax_serve_engine")
    assert mine.splitlines()[0] == theirs.splitlines()[0] == "served 12 requests"
    a, b = _leaves(_json_tail(mine)), _leaves(_json_tail(theirs))
    assert a.keys() == b.keys()
    ints = {k: v for k, v in b.items() if isinstance(v, int) and not isinstance(v, bool)}
    assert {k: a[k] for k in ints} == ints
    for key in ("/slot_writes", "/searches", "/rounds", "/eliminated", "/cache_hit_blocks",
                "/metrics/counters/admitted", "/metrics/counters/decode_tokens", "/session_scans"):
        assert key in ints


def test_train_example_resumes_to_the_uninterrupted_losses(runs):
    full = _json_tail(_ok(runs, "train_full"))
    crash = _ok(runs, "train_crash")
    resumed_text = _ok(runs, "train_resume")
    assert f"[crash] injected failure at step {FAIL_AT}" in crash and "{" not in crash
    assert "[resume] from durable checkpoint @ step 5" in resumed_text
    resumed = _json_tail(resumed_text)
    assert full["resumed_from"] is None and resumed["resumed_from"] == 5
    assert full["final_step"] == resumed["final_step"] == 10
    assert resumed["final_loss"] == full["final_loss"]
    keep = lambda rows: [(r["step"], r["loss"], r["grad_norm"]) for r in rows if r["step"] > 5]
    assert keep(resumed["history"]) == keep(full["history"]) != []


@pytest.mark.parametrize("name", [f"{n}_torch" for n in TWINS] + ["train_lm_torch"])
def test_example_without_a_card_raises(monkeypatch, tmp_path, name):
    """The card is the default: on a host without one an example raises
    before it computes anything, as the port's constructors do."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--ckpt", str(tmp_path / "ck")] if name == "train_lm_torch" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
