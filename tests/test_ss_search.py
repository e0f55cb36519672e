"""The SS/temporal full-search SSE map (models/ss_scan.sse_map) against an
exact int64 NumPy SSE, at the precision the map pins (f32, HIGHEST)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from chip_smoke import np_sse
from hevc_hop_tpu.models import ss_scan


@pytest.mark.parametrize("n", [8, 16])
def test_sse_map_matches_exact_sse(n):
    radius = 16
    rng = np.random.default_rng(n)
    b = 6
    wsz = n + 2 * radius
    # samples below 181: sum(org^2) + sum(ref^2) < 2^24 at n = 16, so every
    # f32 partial sum is an exact integer and the map must be exact
    win = rng.integers(0, 181, (b, wsz, wsz)).astype(np.int32)
    org = rng.integers(0, 181, (b, n, n)).astype(np.int32)
    # one block also appears verbatim in its window: SSE 0 at its offset
    org[0] = win[0, 5:5 + n, 9:9 + n]
    got = np.asarray(jax.jit(ss_scan.sse_map)(jnp.asarray(win),
                                              jnp.asarray(org)))
    exact = np_sse(win, org)
    assert got.shape == (b, 2 * radius + 1, 2 * radius + 1)
    np.testing.assert_array_equal(got, exact.astype(np.float32))
    assert got[0, 5, 9] == 0 and got[0].argmin() == 5 * (2 * radius + 1) + 9
