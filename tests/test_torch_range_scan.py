"""Port parity of the range_scan kernel's plain version: against the JAX
int64 reference (``range_scan_ref``) for candidate widths up to 1024, caps
below and above the width, and rows holding a key twice; against the
Pallas kernel in interpret mode on unique-key int32 rows.  Integer outputs,
zero tolerance (``np.array_equal``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (enables jax x64 before any JAX input is built)
import jax.numpy as jnp  # noqa: E402

from repro.kernels.range_scan.kernel import range_scan_pallas  # noqa: E402
from repro.kernels.range_scan.ref import range_scan_ref as jrange_scan_ref  # noqa: E402
from repro_torch.kernels.range_scan import range_scan, range_scan_ref  # noqa: E402

EMPTY64 = np.iinfo(np.int64).max
EMPTY32 = np.iinfo(np.int32).max


def _rows(bsz, n, seed, *, dup: bool, empty):
    rng = np.random.default_rng(seed)
    if dup:  # small key space: many keys appear twice or more in a row
        keys = rng.integers(0, max(4, n // 3), (bsz, n))
    else:
        keys = np.stack([rng.choice(10**7, size=n, replace=False) for _ in range(bsz)])
    keys = np.where(rng.random((bsz, n)) < 0.3, empty, keys)
    vals = rng.integers(0, 10**6, (bsz, n))
    lo = rng.integers(0, max(4, n // 6) if dup else 10**7, bsz)
    hi = lo + rng.integers(0, n if dup else 10**7, bsz)
    return keys, vals, lo, hi


@pytest.mark.parametrize(
    "bsz,n,cap,dup",
    [(4, 16, 8, False), (3, 88, 128, False), (8, 128, 16, True), (2, 512, 128, True),
     (2, 1024, 128, False), (1, 1024, 2048, True), (5, 33, 1, True), (3, 7, 64, True)],
)
def test_range_scan_plain_equals_jax_ref(bsz, n, cap, dup):
    """int64 rows, EMPTY holes, caps below and above n, duplicate keys (the
    stable argsort keeps candidate order between equal keys)."""
    keys, vals, lo, hi = _rows(bsz, n, n * cap + dup, dup=dup, empty=EMPTY64)
    want = jrange_scan_ref(*(jnp.asarray(x, jnp.int64) for x in (keys, vals, lo, hi)), cap)
    args = tuple(torch.as_tensor(x, dtype=torch.int64) for x in (keys, vals, lo, hi))
    got = range_scan(*args, cap=cap)
    oracle = range_scan_ref(*args, cap)
    for g, o, w, name in zip(got, oracle, want, ("keys", "vals", "count", "truncated")):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
        assert torch.equal(g, o), name


def test_range_scan_saturated_upper_bound():
    """hi = EMPTY (a span past the top of the key space) scans everything
    >= lo and still never emits the EMPTY sentinel itself."""
    keys = np.array([[5, EMPTY64, EMPTY64 - 1, 3, 9]], np.int64)
    vals = np.arange(5, dtype=np.int64)[None]
    lo, hi = np.array([4], np.int64), np.array([EMPTY64], np.int64)
    want = jrange_scan_ref(*(jnp.asarray(x) for x in (keys, vals, lo, hi)), 4)
    got = range_scan(*(torch.as_tensor(x) for x in (keys, vals, lo, hi)), cap=4)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[0][0].tolist() == [5, 9, EMPTY64 - 1, EMPTY64]


@pytest.mark.parametrize("bsz,n,cap", [(8, 64, 16), (3, 88, 128), (2, 300, 64)])
def test_range_scan_plain_equals_pallas_interpret(bsz, n, cap):
    """Unique-key int32 rows (the Pallas rank assumes unique keys): the plain
    version on the widened int64 rows equals the interpreted kernel once its
    INT32_MAX sentinel is widened back to the int64 EMPTY."""
    keys, vals, lo, hi = _rows(bsz, n, n + cap, dup=False, empty=EMPTY32)
    pk, pv, pc, pt = range_scan_pallas(
        *(jnp.asarray(x, jnp.int32) for x in (keys, vals, lo, hi)), cap=cap, interpret=True
    )
    keys64 = np.where(keys == EMPTY32, EMPTY64, keys)
    got = range_scan(*(torch.as_tensor(x, dtype=torch.int64) for x in (keys64, vals, lo, hi)), cap=cap)
    pk = np.asarray(pk).astype(np.int64)
    assert np.array_equal(got[0].numpy(), np.where(pk == EMPTY32, EMPTY64, pk))
    assert np.array_equal(got[1].numpy(), np.asarray(pv).astype(np.int64))
    assert np.array_equal(got[2].numpy(), np.asarray(pc))
    assert np.array_equal(got[3].numpy(), np.asarray(pt))
