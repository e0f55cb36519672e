"""Forward/inverse integer transforms as batched s32 matmuls.

Replaces the reference's scalar partial-butterfly C++ loops
(TComTrQuant.cpp:400-780 partialButterfly{4,8,16,32} + inverses and the 4x4
DST) with dense [B, N, N] x [N, N] integer matmuls: a whole frame's worth
of same-size TUs is transformed in one batched op. The products stay s32
with s32 accumulation (exact); they must never move to f32, whose 24-bit
significand cannot hold the inverse transform's second-stage partial sums.

Bit-exactness: all math is int32 with the H.265 8.6.4 shift/round/clip
conventions. The *inverse* transform (normative, used by the decoder and the
encoder recon loop) clips the intermediate to 16 bits exactly as the spec
requires. The forward transform matches HM's encoder-side convention
(shift1 = log2N + bitDepth - 9, shift2 = log2N + 6) so RD decisions and
coefficients match the reference.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from hevc_hop_tpu.common import rom
from hevc_hop_tpu.common.types import COEF_MIN, COEF_MAX


@functools.lru_cache(maxsize=None)
def _mat(n: int, dst: bool) -> np.ndarray:
    return rom.DST4 if dst else rom.dct_matrix(n)


def _rshift_round(x: jnp.ndarray, shift: int) -> jnp.ndarray:
    # arithmetic shift with rounding offset, exact HM/H.265 convention
    return (x + (1 << (shift - 1))) >> shift


def fwd_transform(resi: jnp.ndarray, bit_depth: int = 8,
                  use_dst: bool = False) -> jnp.ndarray:
    """Forward 2-D transform of a batch of residual blocks.

    resi: [..., N, N] int32. Returns coefficients [..., N, N] int32.
    Column transform first (T @ R), then row transform (tmp @ T^T) — HM's
    partialButterfly order (horizontal stage first on rows then vertical).
    """
    n = resi.shape[-1]
    log2n = n.bit_length() - 1
    t = jnp.asarray(_mat(n, use_dst), jnp.int32)
    shift1 = log2n + bit_depth - 9
    shift2 = log2n + 6
    # stage 1: 1-D transform along rows of the block (contract over columns)
    tmp = _rshift_round(
        jax.lax.dot_general(resi, t.T,
                            dimension_numbers=(((resi.ndim - 1,), (0,)),
                                               ((), ())),
                            preferred_element_type=jnp.int32), shift1)
    # stage 2: transform along the other axis
    out = _rshift_round(
        jnp.einsum("ky,...yx->...kx", t, tmp,
                   preferred_element_type=jnp.int32), shift2)
    return out


def inv_transform(coef: jnp.ndarray, bit_depth: int = 8,
                  use_dst: bool = False) -> jnp.ndarray:
    """Inverse 2-D transform (H.265 8.6.4, bit-exact incl. 16-bit clamps).

    coef: [..., N, N] int32 -> residual [..., N, N] int32.
    """
    n = coef.shape[-1]
    t = jnp.asarray(_mat(n, use_dst), jnp.int32)
    shift1 = 7
    shift2 = 20 - bit_depth
    # stage 1: vertical inverse:  e = clip16((T^T @ C + 64) >> 7)
    e = jnp.einsum("yk,...yx->...kx", t, coef,
                   preferred_element_type=jnp.int32)
    e = jnp.clip(_rshift_round(e, shift1), COEF_MIN, COEF_MAX)
    # stage 2: horizontal inverse: r = clip16((e @ T + off) >> shift2)
    r = jax.lax.dot_general(e, t,
                            dimension_numbers=(((e.ndim - 1,), (0,)),
                                               ((), ())),
                            preferred_element_type=jnp.int32)
    r = jnp.clip(_rshift_round(r, shift2), COEF_MIN, COEF_MAX)
    return r


def fwd_transform_skip(resi: jnp.ndarray, bit_depth: int = 8) -> jnp.ndarray:
    """Transform-skip forward scaling (HM xTransformSkip, 4x4 only)."""
    n = resi.shape[-1]
    log2n = n.bit_length() - 1
    shift = rom.MAX_TR_DYNAMIC_RANGE - bit_depth - log2n
    if shift >= 0:
        return resi << shift
    return _rshift_round(resi, -shift)


def inv_transform_skip(coef: jnp.ndarray, bit_depth: int = 8) -> jnp.ndarray:
    """Transform-skip inverse scaling (H.265 8.6.4.2 ts path)."""
    n = coef.shape[-1]
    log2n = n.bit_length() - 1
    shift = rom.MAX_TR_DYNAMIC_RANGE - bit_depth - log2n
    if shift > 0:
        return _rshift_round(coef, shift)
    if shift == 0:
        return coef
    return coef << (-shift)
