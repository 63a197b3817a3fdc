"""The backward of the port's ``pipeline_apply`` against JAX's on the CPU.

JAX's reference is ``jax.grad`` of its ``pipeline_apply`` on
``tests/test_pipeline_dedup.py``'s 4-stage tanh stack with the loss
``sum(out * g)``, in one subprocess on a 4-device host mesh
(``--xla_force_host_platform_device_count=4``) under ``jax.set_mesh`` +
``jax.jit`` (``JaxPipelineGrads``); the same subprocess gives the
sequential stack's ``jax.grad``.  ``tests/test_torch_parallel.py`` starts
it beside its 8-rank gloo job (pod=4, data=2), takes the port's 4-stage
gradients on every rank and holds both to each other and to the stack
there (``test_pipeline_grads_match_jax_on_every_rank``,
``test_jax_pipeline_grads_equal_the_sequential_stacks``).  This file holds
the one-stage pipeline (a 1-rank gloo mesh in process) to JAX's 1-device
``jax.grad`` and to the stage's own autograd, for whole and ``DTensor``
params, all within ``GRAD_TOL``.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parallel import pipe_cotangent, pipe_inputs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = 1e-5  # f32 sums in another order; a gradient scaled by the stage count is O(1) off
JAX_TIMEOUT_S = 240

_JAX_GRADS = """
import json, os, sys
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
sys.path.insert(0, os.path.join(os.getcwd(), 'tests'))
import numpy as np, jax, jax.numpy as jnp
from repro.parallel.pipeline import pipeline_apply
from test_torch_parallel import PIPE, pipe_cotangent, pipe_inputs

mesh = jax.make_mesh((PIPE['n_stages'],), ('pod',))
w, x = (jnp.asarray(a) for a in pipe_inputs())
g = jnp.asarray(pipe_cotangent())
body = lambda wi, h: jnp.tanh(h @ wi)

def piped(w, x):
    return jnp.sum(pipeline_apply({'w': w}, x, lambda p, h: body(p['w'], h), mesh) * g)

def seq(w, x):
    for s in range(PIPE['n_stages']):
        x = body(w[s], x)
    return jnp.sum(x * g)

with jax.set_mesh(mesh):
    gw, gx = jax.jit(jax.grad(piped, argnums=(0, 1)))(w, x)
gw_seq, gx_seq = jax.jit(jax.grad(seq, argnums=(0, 1)))(w, x)
print('JAX_GRADS=' + json.dumps({k: np.asarray(v).tolist() for k, v in
      dict(gw=gw, gx=gx, gw_seq=gw_seq, gx_seq=gx_seq).items()}))
"""


class JaxPipelineGrads:
    """The JAX subprocess, started at construction; ``result()`` waits for
    it and returns ``gw``, ``gx`` (the pipeline's) and ``gw_seq``,
    ``gx_seq`` (the sequential stack's) as float32 arrays."""

    def __init__(self):
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
        self.proc = subprocess.Popen([sys.executable, "-c", _JAX_GRADS], cwd=ROOT, env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._result = None

    def result(self) -> dict:
        if self._result is None:
            out, err = self.proc.communicate(timeout=JAX_TIMEOUT_S)
            line = [ln for ln in out.splitlines() if ln.startswith("JAX_GRADS=")]
            assert self.proc.returncode == 0 and line, (out + err)[-3000:]
            self._result = {k: np.asarray(v, np.float32)
                            for k, v in json.loads(line[0][len("JAX_GRADS="):]).items()}
        return self._result

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def stack_grads(w, x, g):
    """The sequential stack's output and gradients by torch autograd."""
    w, x = (torch.from_numpy(a).requires_grad_() for a in (w, x))
    out = x
    for s in range(w.shape[0]):
        out = torch.tanh(out @ w[s])
    gw, gx = torch.autograd.grad((out * torch.from_numpy(g)).sum(), [w, x])
    return out.detach().numpy(), gw.numpy(), gx.numpy()


@pytest.fixture(scope="module")
def pod_mesh():
    from repro_torch.launch.mesh import make_host_mesh, make_mesh, shutdown

    make_host_mesh(device="cpu")
    try:
        yield make_mesh((1,), ("pod",), "cpu")
    finally:
        shutdown()


def _one_stage():
    w, x = pipe_inputs()
    return w[:1], x, pipe_cotangent()


@functools.lru_cache(maxsize=None)
def _jax_one_stage_grads():
    import repro.core  # noqa: F401
    import jax
    import jax.numpy as jnp
    from repro.parallel.pipeline import pipeline_apply as jpipe

    w, x, g = (jnp.asarray(a) for a in _one_stage())
    mesh = jax.make_mesh((1,), ("pod",))

    def loss(w, x):
        return jnp.sum(jpipe({"w": w}, x, lambda p, h: jnp.tanh(h @ p["w"]), mesh) * g)

    with jax.set_mesh(mesh):
        gw, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(w, x)
    return np.asarray(gw), np.asarray(gx)


@pytest.mark.parametrize("placement", ["whole", "dtensor"])
def test_one_stage_pipeline_grads_match_jax(pod_mesh, placement):
    """One stage (the hand-off is the identity, no message): the port's
    gradients equal JAX's 1-device ``jax.grad`` and the stage's own
    autograd; a DTensor param keeps its placement in its gradient."""
    from torch.distributed.tensor import DTensor

    from repro_torch._shardmap_compat import NamedSharding, PartitionSpec, distribute
    from repro_torch.parallel.pipeline import pipeline_apply

    w, x, g = _one_stage()
    wt = torch.from_numpy(w)
    if placement == "dtensor":
        wt = distribute(wt, NamedSharding(pod_mesh, PartitionSpec("pod", None, None)))
    wt = wt.detach().requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    out = pipeline_apply({"w": wt}, xt, lambda p, h: torch.tanh(h @ p["w"]), pod_mesh)
    gw, gx = torch.autograd.grad((out * torch.from_numpy(g)).sum(), [wt, xt])
    if placement == "dtensor":
        assert isinstance(gw, DTensor) and gw.placements == wt.placements
        gw = gw.full_tensor()
    want_out, stage_gw, stage_gx = stack_grads(w, x, g)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=GRAD_TOL)
    jgw, jgx = _jax_one_stage_grads()
    for got, jax_g, stage_g in ((gw, jgw, stage_gw), (gx, jgx, stage_gx)):
        np.testing.assert_allclose(got.numpy(), jax_g, atol=GRAD_TOL)
        np.testing.assert_allclose(got.numpy(), stage_g, atol=GRAD_TOL)


def test_pipeline_without_grad_records_nothing(pod_mesh):
    """Under ``no_grad`` (and with no input that requires a gradient) the
    loop builds no graph and gives the same outputs."""
    from repro_torch.parallel.pipeline import pipeline_apply

    w, x, _ = _one_stage()
    body = lambda p, h: torch.tanh(h @ p["w"])
    wt, xt = torch.from_numpy(w), torch.from_numpy(x)
    plain = pipeline_apply({"w": wt}, xt, body, pod_mesh)
    with torch.no_grad():
        quiet = pipeline_apply({"w": wt.clone().requires_grad_()}, xt, body, pod_mesh)
    live = pipeline_apply({"w": wt.clone().requires_grad_()}, xt, body, pod_mesh)
    assert not plain.requires_grad and not quiet.requires_grad and live.requires_grad
    assert torch.equal(plain, quiet) and torch.equal(plain, live.detach())
