"""The port's mamba2 block and the hybrid family (zamba2) against the JAX
package on the CPU.

At ``reduced(zamba2-1.2b)`` (4 mamba2 layers, the shared attention block
after every 2 of them; d_model 128, state 16, head dim 16, chunk 16; f32)
with the same seeded numpy params in both packages:

* the block: ``mamba2_train`` over two chunks (its step bias spread over
  ±30, where ``F.softplus`` would switch to its identity), three
  ``mamba2_decode`` steps from an empty cache (outputs, state and conv
  tail) and the gradient of ``A_log`` and of ``in_proj`` through the
  chunked form, finite although ``_segsum`` puts -inf above the diagonal:
  within atol / rtol 1e-5;
* the model, as ``test_torch_xlstm.family_run`` checks it: logits,
  loss, every grad leaf, three decode steps with their caches (the
  ``SSMCache`` stack and the shared block's ``KVCache`` stack),
  ``compute_params`` and the params crossing unchanged;
* a serial ``ServeEngine`` of two requests giving JAX's tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 before any JAX input is built)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402

from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from test_torch_moe import _np_tree  # noqa: E402
from test_torch_xlstm import (  # noqa: E402
    CELL_TOL,
    DECODE_STEPS,
    ENGINE_REQUESTS,
    check_compute_params,
    check_decode_step,
    check_forward_train,
    check_loss_and_grads,
    check_params_cross,
    cfgs,
    engine_tokens,
    family_run,
)

ARCH = "zamba2-1.2b"
B, T = 2, 32  # two chunks of the reduced ssm_chunk (16)


@pytest.fixture(scope="module")
def block():
    t, j = cfgs(ARCH)
    rng = np.random.default_rng(5)
    spec = jssm.mamba2_spec(j)
    p = {k: (rng.standard_normal(s.shape) * (0.05 if s.init == "normal" else 0.3))
         .astype(np.float32) for k, s in spec.items()}
    p["dt_bias"] = np.linspace(-30.0, 30.0, spec["dt_bias"].shape[0]).astype(np.float32)
    x = rng.standard_normal((B, T, t.d_model)).astype(np.float32)
    w = rng.standard_normal((B, T, t.d_model)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)

    @jax.jit
    def ref(jp, x, w):
        grads = jax.grad(lambda q: jnp.sum(jssm.mamba2_train(q, x, j) * w))(jp)
        out = {"train": jssm.mamba2_train(jp, x, j), "grad_A_log": grads["A_log"],
               "grad_in_proj": grads["in_proj"]}
        cache = jax.tree.map(jnp.zeros_like, jssm.ssm_cache_spec(j, B))
        for i in range(DECODE_STEPS):
            y, cache = jssm.mamba2_decode(jp, x[:, i:i + 1], j, cache)
            out[f"dec{i}"] = (y, cache)
        return out

    return t, params_from_numpy(p), x, w, _np_tree(ref(jp, jnp.asarray(x), jnp.asarray(w)))


def test_mamba2_train_equals_jax(block):
    t, p, x, _, want = block
    got = ssm.mamba2_train(p, torch.from_numpy(x), t)
    np.testing.assert_allclose(got.numpy(), want["train"], **CELL_TOL)


def test_mamba2_train_needs_whole_chunks(block):
    t, p, x, _, _ = block
    with pytest.raises(AssertionError, match="chunk"):
        ssm.mamba2_train(p, torch.from_numpy(x[:, :T - 3]), t)


def test_mamba2_gradient_leaves_finite_and_equal_jax(block):
    t, p, x, w, want = block
    live = {k: v.clone().requires_grad_(k in ("A_log", "in_proj")) for k, v in p.items()}
    (ssm.mamba2_train(live, torch.from_numpy(x), t) * torch.from_numpy(w)).sum().backward()
    for name in ("A_log", "in_proj"):
        g = live[name].grad.numpy()
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, want[f"grad_{name}"], **CELL_TOL, err_msg=name)


def test_segsum_gradient_is_finite():
    log_a = torch.randn(2, 3, 16, dtype=torch.float32, requires_grad=True)
    torch.exp(ssm._segsum(log_a)).sum().backward()
    assert torch.isfinite(log_a.grad).all()


def test_mamba2_decode_steps_equal_jax(block):
    t, p, x, _, want = block
    spec = ssm.ssm_cache_spec(t, B)
    cache = ssm.SSMCache(*(torch.zeros(s.shape, dtype=s.dtype) for s in spec))
    for i in range(DECODE_STEPS):
        y, cache = ssm.mamba2_decode(p, torch.from_numpy(x[:, i:i + 1]), t, cache)
        wy, wc = want[f"dec{i}"]
        np.testing.assert_allclose(y.numpy(), wy, **CELL_TOL)
        for f, a in zip(cache, wc):
            assert f.shape == a.shape and f.numpy().dtype == a.dtype
            np.testing.assert_allclose(f.numpy(), a, **CELL_TOL)


@pytest.fixture(scope="module")
def run():
    return family_run(ARCH)


def test_forward_train_equals_jax(run):
    check_forward_train(run)


def test_loss_and_grads_equal_jax(run):
    check_loss_and_grads(run)


@pytest.mark.parametrize("step", range(DECODE_STEPS))
def test_forward_decode_equals_jax(run, step):
    check_decode_step(run, step)


def test_params_cross_unchanged(run):
    check_params_cross(run)


def test_compute_params_give_the_same_outputs():
    _, cast = check_compute_params(ARCH)
    cell = cast["mamba"]["ssm"]
    assert {k for k, v in cell.items() if v.dtype == torch.float32} == \
        {"A_log", "dt_bias", "D", "norm_w"}
    assert cast["shared"]["in_proj"].dtype == torch.bfloat16
    assert cast["shared"]["block"]["ffn"]["wi"].dtype == torch.bfloat16
    assert cast["shared"]["block"]["ln1"]["scale"].dtype == torch.float32


def test_engine_tokens_equal_jax():
    want, got = engine_tokens(ARCH)
    assert got == want and len(got) == len(ENGINE_REQUESTS)
