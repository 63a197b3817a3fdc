"""Decode attention of the port against the JAX package.

The port's plain version (``repro_torch.kernels.decode_attention.ref``,
which the wrapper takes for CPU tensors) is held against the JAX reference
and the Pallas kernel run with ``interpret=True`` on the same seeded
inputs: f32 within 1e-5 (summation order only), bf16 within 2e-2 (one bf16
ulp of an O(1) output).  The kernel itself runs only on the card
(``tests/test_torch_gpu.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.kernel import decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as jref  # noqa: E402

from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import TILE, split_plan  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402

CASES = [  # b, h, kh, s, d, kv_len, dtype
    (1, 4, 4, 256, 64, None, "float32"),
    (2, 14, 2, 300, 64, 77, "float32"),  # qwen2-0.5b's G = 7, S not a multiple of 256
    (2, 14, 2, 1024, 64, 1000, "bfloat16"),
    (1, 8, 2, 200, 128, 1, "float32"),  # a single live column
    (3, 4, 1, 520, 32, 519, "bfloat16"),  # MQA at the reduced configs' head dim
]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(b, h, kh, s, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, d)).astype(np.float32),
            rng.standard_normal((b, kh, s, d)).astype(np.float32),
            rng.standard_normal((b, kh, s, d)).astype(np.float32))


@pytest.mark.parametrize("b,h,kh,s,d,kv_len,dtype", CASES)
def test_plain_version_equals_jax_ref_and_pallas(b, h, kh, s, d, kv_len, dtype):
    q, k, v = _inputs(b, h, kh, s, d, seed=s + h + d)
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    want = np.asarray(jref(jq, jk, jv, kv_len), np.float32)
    pallas = np.asarray(
        decode_attention_pallas(jq, jk, jv, kv_len, block_k=128, interpret=True), np.float32
    )
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    got = decode_attention_ref(tq, tk, tv, kv_len)
    assert got.dtype == td and tuple(got.shape) == (b, h, d)
    got = got.float().numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
    if dtype == "bfloat16":  # and within 2 bf16 ulps at the output's largest magnitude
        top = float(np.abs(want).max())
        ulp = float(torch.finfo(torch.bfloat16).eps) * 2.0 ** np.floor(np.log2(top))
        assert np.abs(got - want).max() <= 2 * ulp
        assert np.abs(got - pallas).max() <= 2 * ulp
    # the public wrapper sends CPU tensors to the plain version
    assert torch.equal(decode_attention(tq, tk, tv, kv_len), decode_attention_ref(tq, tk, tv, kv_len))


def test_masked_columns_do_not_matter():
    q, k, v = _inputs(2, 14, 2, 300, 64, seed=5)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    a = decode_attention_ref(tq, tk, tv, 100)
    tk[:, :, 100:] = 1e4
    tv[:, :, 100:] = -1e4
    assert torch.equal(decode_attention_ref(tq, tk, tv, 100), a)


@pytest.mark.parametrize("batch,kv_heads", [(8, 2), (1, 1), (64, 8), (3, 2)])
def test_split_plan_covers_kv_len_with_no_empty_split(batch, kv_heads):
    """The kernel's host-side sizing: splits of whole tiles that cover
    exactly [0, kv_len) with every split holding at least one column."""
    for kv_len in (1, 31, 32, 33, 517, 1000, 1024, 4096, 32768):
        n_split, chunk = split_plan(batch, kv_heads, kv_len)
        assert chunk % TILE == 0 and n_split >= 1
        assert (n_split - 1) * chunk < kv_len <= n_split * chunk
