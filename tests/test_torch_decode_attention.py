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
from repro_torch.kernels.decode_attention.kernel import MAX_CLUSTER, cluster_plan  # noqa: E402
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


# clusters of n blocks that fit on the card at once, as the CUDA runtime
# (cudaOccupancyMaxActiveClusters) reports them on an NVIDIA H100 80GB HBM3
# for the bf16, D = 64, G = 7 instance: a cluster's blocks share one GPC
H100_CAPACITY = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
# a card of 132 SMs whose clusters of any size pack its SMs fully: the plan
# is never cut to fit, only sized to the card
PACKED_CAPACITY = {n: 132 // n for n in range(1, MAX_CLUSTER + 1)}
CAPACITIES = (H100_CAPACITY.__getitem__, PACKED_CAPACITY.__getitem__)


def _assert_plan_covers(batch, kv_heads, kv_len, capacity):
    n_blocks, chunk = cluster_plan(batch, kv_heads, kv_len, capacity)
    assert 1 <= n_blocks <= MAX_CLUSTER
    ranges = [(r * chunk, min((r + 1) * chunk, kv_len)) for r in range(n_blocks)]
    assert all(lo < hi for lo, hi in ranges), (kv_len, ranges)  # no empty block
    covered = [c for lo, hi in ranges for c in range(lo, hi)]
    assert covered == list(range(kv_len)), kv_len  # every column once, in order


@pytest.mark.parametrize("batch,kv_heads", [(8, 2), (1, 1), (64, 8), (3, 2)])
def test_split_plan_covers_kv_len_with_no_empty_split(batch, kv_heads):
    """The kernel's host-side sizing (``cluster_plan``, with the H100's
    cluster capacities and with ones that never cut the plan): the blocks of
    a cluster cover exactly [0, kv_len), each holding at least one column."""
    for capacity in CAPACITIES:
        for kv_len in (1, 31, 32, 33, 517, 1000, 1024, 4096, 32768):
            _assert_plan_covers(batch, kv_heads, kv_len, capacity)


@pytest.mark.parametrize("batch_kv_heads", [2, 16, 64])
def test_cluster_plan_covers_every_column_once(batch_kv_heads):
    """Every kv_len in 1..1024 at B·KH of 2, 16 (the serving shape) and 64,
    with both capacity tables: at most 8 blocks a cluster, none empty,
    every column covered once."""
    for capacity in CAPACITIES:
        for kv_len in range(1, 1025):
            _assert_plan_covers(batch_kv_heads, 1, kv_len, capacity)


def test_cluster_plan_at_the_serving_shape():
    """qwen2-0.5b serving (B = 8, KH = 2, kv_len 543): on a card whose
    clusters pack its 132 SMs, 16 clusters of 8 blocks, 68 columns a block;
    on the H100, whose 15 clusters of 8 would leave the 16th for a second
    wave, 16 clusters of 6 (96 blocks), 91 columns a block."""
    assert cluster_plan(8, 2, 543, PACKED_CAPACITY.__getitem__) == (8, 68)
    assert cluster_plan(8, 2, 543, H100_CAPACITY.__getitem__) == (6, 91)


@pytest.mark.parametrize("n_clusters", [1, 2, 16, 17, 31, 64, 132, 200])
def test_cluster_plan_puts_every_cluster_on_the_card(n_clusters):
    """With the card's capacity the clusters shrink until all of them fit at
    once (to 1 block where even that cannot be), and still cover every
    column once with no empty block."""
    cap = H100_CAPACITY.__getitem__
    for kv_len in (1, 15, 16, 17, 100, 543, 1024, 4096):
        _assert_plan_covers(n_clusters, 1, kv_len, cap)
        n_blocks, _ = cluster_plan(n_clusters, 1, kv_len, cap)
        assert n_blocks == 1 or cap(n_blocks) >= n_clusters
        if n_blocks < MAX_CLUSTER and n_blocks < -(-kv_len // 16):  # not cut by columns
            assert cap(n_blocks + 1) < n_clusters or n_blocks * n_clusters >= cap(1)
