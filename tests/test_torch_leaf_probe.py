"""The leaf probe of the port against the JAX package, bit for bit.

The port's plain version (``repro_torch.kernels.leaf_probe.ref``, which the
wrappers take for CPU tensors) is held against the JAX reference and the
Pallas kernel run with ``interpret=True`` (int32 rows, the shapes of
``tests/test_kernels.py``'s sweep), and ``leaf_probe_i64`` against the JAX
package's hi/lo-split ``leaf_probe_i64`` on int64 keys, including keys that
differ only in their high 32 bits.  The CUDA kernel itself runs only on the
card (``tests/test_torch_gpu.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (turns on jax_enable_x64: int64 keys stay int64)
import jax.numpy as jnp  # noqa: E402

from repro.kernels.leaf_probe import leaf_probe_i64 as jprobe_i64  # noqa: E402
from repro.kernels.leaf_probe import leaf_probe_pallas, leaf_probe_ref as jref  # noqa: E402

from repro_torch.kernels.leaf_probe import leaf_probe, leaf_probe_i64, leaf_probe_ref  # noqa: E402


def _rows(bsz, b, seed):
    """tests/test_kernels.py's inputs: int32 rows with some guaranteed hits
    and no key twice in a row."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 50, (bsz, b)).astype(np.int32)
    vals = rng.integers(0, 1000, (bsz, b)).astype(np.int32)
    queries = rng.integers(0, 50, (bsz,)).astype(np.int32)
    queries[: bsz // 2] = keys[: bsz // 2, rng.integers(0, b)]
    for i in range(bsz):
        seen = set()
        for j in range(b):
            if int(keys[i, j]) in seen:
                keys[i, j] = -7 - j
            seen.add(int(keys[i, j]))
    return keys, vals, queries


def _eq(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].dtype == torch.int32


@pytest.mark.parametrize("bsz,b", [(1, 8), (7, 8), (64, 8), (200, 16), (33, 11)])
def test_plain_version_equals_jax_ref_and_pallas(bsz, b):
    keys, vals, queries = _rows(bsz, b, seed=bsz * 31 + b)
    jargs = tuple(jnp.asarray(x) for x in (keys, vals, queries))
    targs = tuple(torch.from_numpy(x) for x in (keys, vals, queries))
    got = leaf_probe_ref(*targs)
    _eq(got, jref(*jargs))
    _eq(got, leaf_probe_pallas(*jargs, interpret=True))
    assert got[1].dtype == torch.int32
    # the public wrapper sends CPU tensors to the plain version
    w = leaf_probe(*targs)
    assert torch.equal(w[0], got[0]) and torch.equal(w[1], got[1])


def test_duplicate_keys_take_the_first_slot():
    keys = np.array([[5, 3, 5, 3], [1, 1, 1, 1], [9, 8, 7, 6]], np.int32)
    vals = np.arange(12, dtype=np.int32).reshape(3, 4)
    queries = np.array([3, 1, 4], np.int32)
    got = leaf_probe_ref(*(torch.from_numpy(x) for x in (keys, vals, queries)))
    _eq(got, jref(*(jnp.asarray(x) for x in (keys, vals, queries))))
    assert got[0].tolist() == [1, 0, -1] and got[1].tolist() == [1, 4, 0]


@pytest.mark.parametrize("bsz,b,use_pallas", [(64, 11, False), (64, 11, True), (300, 16, False)])
def test_i64_equals_jax_hi_lo_split(bsz, b, use_pallas):
    rng = np.random.default_rng(bsz + b)
    keys = rng.integers(-(2**62), 2**62, (bsz, b)).astype(np.int64)
    vals = rng.integers(0, 10**6, (bsz, b)).astype(np.int32)
    queries = rng.integers(-(2**62), 2**62, bsz).astype(np.int64)
    hits = rng.random(bsz) < 0.5
    cols = rng.integers(0, b, bsz)
    queries[hits] = keys[hits, cols[hits]]
    # near misses: the low 32 bits of a key with other high bits, in another
    # slot of the same row, or as the query
    near = np.nonzero(~hits)[0][: bsz // 4]
    keys[near, 0] = queries[near] ^ (1 << 40)
    keys[near[: len(near) // 2], 1] = queries[near[: len(near) // 2]]
    keys[near[: len(near) // 2], 2] = queries[near[: len(near) // 2]]  # duplicate: slot 1 wins
    want = jprobe_i64(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(queries),
                      use_pallas=use_pallas, interpret=True)
    got = leaf_probe_i64(*(torch.from_numpy(x) for x in (keys, vals, queries)))
    _eq(got, want)
    assert (got[0].numpy() >= 0).sum() > bsz // 4


def test_i64_values_keep_their_dtype():
    keys = torch.tensor([[1 << 40, 2, 3]], dtype=torch.int64)
    vals = torch.tensor([[-(1 << 50), 7, 8]], dtype=torch.int64)
    slot, val = leaf_probe_i64(keys, vals, torch.tensor([1 << 40]))
    assert slot.tolist() == [0] and val.tolist() == [-(1 << 50)] and val.dtype == torch.int64
    slot, val = leaf_probe_i64(keys, vals, torch.tensor([(1 << 40) + (1 << 33)]))
    assert slot.tolist() == [-1] and val.tolist() == [0]
