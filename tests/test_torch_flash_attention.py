"""Flash attention of the port against the JAX package.

The port's plain version (``repro_torch.kernels.flash_attention.ref``,
which the wrapper takes for CPU tensors) is held against the JAX reference
and the Pallas kernel run with ``interpret=True`` on the same seeded
inputs, at the shapes of ``tests/test_kernels.py``'s flash-attention sweep:
f32 within 2e-5 (summation order only), bf16 within 2e-2 (one bf16 ulp of
an O(1) output).  The wrapper's gradients on the CPU (the plain version's
autograd, the port's backward) are held against ``jax.grad`` of the JAX
package's ``flash_attention`` (Pallas forward, the reference's VJP) within
1e-5.  The CUDA kernel itself runs only on the card
(``tests/test_torch_gpu.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jref  # noqa: E402

from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

CASES = [  # b, h, kh, s, d, causal, window, dtype
    (1, 2, 2, 128, 64, True, 0, "float32"),
    (2, 4, 2, 256, 64, True, 0, "float32"),  # GQA
    (1, 8, 1, 128, 64, True, 0, "bfloat16"),  # MQA bf16
    (1, 2, 2, 200, 32, True, 0, "float32"),  # ragged pad
    (1, 2, 1, 256, 64, True, 64, "float32"),  # sliding window
    (1, 2, 2, 128, 128, False, 0, "float32"),  # bidirectional
    (1, 2, 2, 100, 32, False, 0, "float32"),  # ragged, not causal: pad keys get no mass
    (1, 14, 2, 96, 64, True, 0, "bfloat16"),  # qwen2-0.5b's G = 7
    (1, 4, 2, 72, 80, True, 0, "float32"),  # h2o-danube's D = 80
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(b, h, kh, s, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, kh, s, d)).astype(np.float32),
            rng.standard_normal((b, kh, s, d)).astype(np.float32))


@pytest.mark.parametrize("b,h,kh,s,d,causal,window,dtype", CASES)
def test_plain_version_equals_jax_ref_and_pallas(b, h, kh, s, d, causal, window, dtype):
    q, k, v = _inputs(b, h, kh, s, d, seed=s + h)
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    want = np.asarray(jref(jq, jk, jv, causal=causal, window=window), np.float32)
    pallas = np.asarray(flash_attention_pallas(
        jq, jk, jv, causal=causal, window=window, block_q=64, block_k=64, interpret=True
    ), np.float32)
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    got = attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == td and tuple(got.shape) == (b, h, s, d)
    got = got.float().numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
    # the public wrapper sends CPU tensors to the plain version
    assert torch.equal(flash_attention(tq, tk, tv, causal, window),
                       attention_ref(tq, tk, tv, causal=causal, window=window))


GRAD_CASES = [  # b, h, kh, s, d, causal, window
    (1, 2, 2, 128, 32, True, 0),  # tests/test_kernels.py's grad case
    (2, 4, 2, 96, 32, True, 0),  # GQA: k/v grads sum over the group
    (1, 2, 1, 130, 32, True, 48),  # window, ragged
    (1, 2, 2, 70, 64, False, 0),  # not causal, ragged
]


@pytest.mark.parametrize("b,h,kh,s,d,causal,window", GRAD_CASES)
def test_gradients_equal_jax(b, h, kh, s, d, causal, window):
    """d/d(q, k, v) of sum(out · w) for a seeded cotangent w."""
    q, k, v = _inputs(b, h, kh, s, d, seed=3 + s)
    w = np.random.default_rng(s).standard_normal((b, h, s, d)).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(jflash(q_, k_, v_, causal, window, None, True) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (flash_attention(tq, tk, tv, causal, window) * torch.from_numpy(w)).sum().backward()
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def test_sm_scale_is_passed_on():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 2, 40, 32, seed=1))
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    want = np.asarray(jref(jq, jk, jv, causal=True, sm_scale=0.3))
    got = flash_attention(q, k, v, True, 0, 0.3).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
