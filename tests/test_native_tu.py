"""Slice-data round-trip with signaled RQT splits (max_hier_depth=2)."""
import random

import numpy as np
import pytest

from hevc_hop_tpu.entropy import ctx_layout, native


def _rand_coefs(rng, n, density):
    c = np.zeros((n, n), np.int16)
    num = max(1, int(n * n * density))
    for _ in range(num):
        y, x = rng.randrange(n), rng.randrange(n)
        mag = min(int(rng.expovariate(0.08)) + 1, 30000)
        c[y, x] = mag if rng.random() < 0.5 else -mag
    return c


def test_slice_roundtrip_with_tu_splits():
    rng = random.Random(11)
    w, h = 64, 64
    for trial in range(5):
        maps = native.SliceMaps(w, h, ctb_log2=5, max_hier_depth=2)
        # CU grid: uniform random depth per CTU for simplicity
        for cy in range(0, h, 32):
            for cx in range(0, w, 32):
                d = rng.choice([0, 1, 2])
                maps.depth8[cy // 8:(cy + 32) // 8, cx // 8:(cx + 32) // 8] = d
                cu = 32 >> d
                for y in range(cy, cy + 32, cu):
                    for x in range(cx, cx + 32, cu):
                        # TU target: uniform per CU, >= 8 (luma DCT TUs)
                        tu = rng.choice([t for t in (3, 4, 5)
                                         if t <= 5 - d and 5 - d - t <= 2])
                        maps.tu4[y // 4:(y + cu) // 4,
                                 x // 4:(x + cu) // 4] = tu
                        maps.mode4[y // 4:(y + cu) // 4,
                                   x // 4:(x + cu) // 4] = rng.randrange(35)
                        # coefficients per TU
                        tun = 1 << tu
                        for ty in range(y, y + cu, tun):
                            for tx in range(x, x + cu, tun):
                                if rng.random() < 0.7:
                                    c = _rand_coefs(rng, tun, 0.2)
                                    maps.coef_y[ty:ty + tun, tx:tx + tun] = c
                                    maps.cbf4_y[ty // 4:(ty + tun) // 4,
                                                tx // 4:(tx + tun) // 4] = (
                                        np.abs(c).max() > 0)
                        # chroma TU = half of luma TU at each leaf (>=4)
                        ctun = max(tun // 2, 4)
                        for ty in range(y, y + cu, max(tun, 8)):
                            for tx in range(x, x + cu, max(tun, 8)):
                                if rng.random() < 0.5:
                                    c = _rand_coefs(rng, ctun, 0.15)
                                    maps.coef_cb[ty // 2:ty // 2 + ctun,
                                                 tx // 2:tx // 2 + ctun] = c
                                    maps.cbf8_cb[ty // 8:(ty + max(tun, 8)) // 8,
                                                 tx // 8:(tx + max(tun, 8)) // 8] = (
                                        np.abs(c).max() > 0)

        states = ctx_layout.init_states(2, 30)
        payload = native.encode_slice_data(states, maps)
        dec = native.decode_slice_data(states, payload, w, h, 5,
                                       max_hier_depth=2)
        np.testing.assert_array_equal(dec.depth8, maps.depth8)
        np.testing.assert_array_equal(dec.tu4, maps.tu4, err_msg="tu4")
        np.testing.assert_array_equal(dec.mode4, maps.mode4)
        np.testing.assert_array_equal(dec.cbf4_y, maps.cbf4_y)
        np.testing.assert_array_equal(dec.coef_y, maps.coef_y)
        np.testing.assert_array_equal(dec.coef_cb, maps.coef_cb)


@pytest.mark.parametrize("touched", list(native._SOURCES) + [None])
def test_native_library_stale_on_any_build_input(touched, tmp_path,
                                                 monkeypatch):
    """A library older than cabac.cpp, a generated header or the Makefile
    is rebuilt, never loaded."""
    import os
    for s in native._SOURCES:
        (tmp_path / s).parent.mkdir(exist_ok=True)
        (tmp_path / s).write_text("x")
        os.utime(tmp_path / s, (1000, 1000))
    lib = tmp_path / "libhevc_hop.so"
    monkeypatch.setattr(native, "_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIB_PATH", str(lib))
    assert native._stale()          # missing
    lib.write_text("so")
    os.utime(lib, (2000, 2000))
    if touched is not None:
        os.utime(tmp_path / touched, (3000, 3000))
    assert native._stale() == (touched is not None)
