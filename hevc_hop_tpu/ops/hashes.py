"""Decoded-picture hashes as device reductions.

Capability ref: TComPicYuvMD5.cpp:141-166 (compChecksum/calcChecksum).
The checksum hash type (H.265 D.3.19 type 2) is a position-masked byte sum
— a pure reduction, so it runs on the device and only 4 bytes per plane
ever cross to the host (MD5 would force a full-frame device->host transfer).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("bit_depth",))
def plane_checksum(plane: jnp.ndarray, bit_depth: int = 8) -> jnp.ndarray:
    """H.265 D.3.19 checksum of one sample plane. Returns uint32 scalar."""
    h, w = plane.shape
    x = jnp.arange(w, dtype=jnp.uint32)[None, :]
    y = jnp.arange(h, dtype=jnp.uint32)[:, None]
    xm = ((x & 255) ^ (y & 255) ^ (x >> 8) ^ (y >> 8)) & 255
    p = plane.astype(jnp.uint32)
    s = jnp.sum((p & 255) ^ xm, dtype=jnp.uint32)
    if bit_depth > 8:
        s = s + jnp.sum((p >> 8) ^ xm, dtype=jnp.uint32)
    return s


def checksum_digests(y, cb, cr, bit_depth: int = 8) -> list:
    """Per-plane 4-byte big-endian checksum digests (device or host arrays).
    All three reductions are fetched in one host roundtrip."""
    sums = jax.device_get([plane_checksum(jnp.asarray(p), bit_depth)
                           for p in (y, cb, cr)])
    return [bytes([(v >> 24) & 255, (v >> 16) & 255, (v >> 8) & 255,
                   v & 255]) for v in (int(s) for s in sums)]


def checksum_digests_np(y, cb, cr, bit_depth: int = 8) -> list:
    """Host (numpy) mirror of checksum_digests for decoder-side verify."""
    out = []
    for plane in (y, cb, cr):
        p = np.asarray(plane).astype(np.uint32)
        h, w = p.shape
        x = np.arange(w, dtype=np.uint32)[None, :]
        yy = np.arange(h, dtype=np.uint32)[:, None]
        xm = ((x & 255) ^ (yy & 255) ^ (x >> 8) ^ (yy >> 8)) & 255
        s = np.sum((p & 255) ^ xm, dtype=np.uint32)
        if bit_depth > 8:
            s = s + np.sum((p >> 8) ^ xm, dtype=np.uint32)
        v = int(s)
        out.append(bytes([(v >> 24) & 255, (v >> 16) & 255,
                          (v >> 8) & 255, v & 255]))
    return out


def crc_digests(y, cb, cr, bit_depth: int = 8) -> list:
    """Per-plane CRC-16 digests (TComPicYuvMD5.cpp:86-133 compCRC).

    HM's variant feeds each data bit at the LSB while reducing by 0x1021 at
    the MSB: per byte B, crc' = ((crc & 0xff) << 8) ^ g[crc >> 8] ^ B with
    g[t] = 8 shift-reduce steps of (t << 8). Finishes with 16 zero bits.
    """
    tab = _crc16_table()
    out = []
    for plane in (y, cb, cr):
        p = np.asarray(plane).astype(np.uint16)
        if bit_depth > 8:
            data = np.empty(p.size * 2, np.uint8)
            data[0::2] = (p & 0xFF).ravel()
            data[1::2] = (p >> 8).ravel()
        else:
            data = (p & 0xFF).astype(np.uint8).ravel()
        crc = 0xFFFF
        for b in data.tolist():
            crc = ((crc & 0xFF) << 8) ^ int(tab[crc >> 8]) ^ b
        for _ in range(16):
            msb = (crc >> 15) & 1
            crc = ((crc << 1) & 0xFFFF) ^ (0x1021 * msb)
        out.append(bytes([(crc >> 8) & 255, crc & 255]))
    return out


@functools.lru_cache(maxsize=1)
def _crc16_table():
    tab = np.zeros(256, np.uint32)
    for b in range(256):
        v = b << 8
        for _ in range(8):
            msb = (v >> 15) & 1
            v = ((v << 1) & 0xFFFF) ^ (0x1021 * msb)
        tab[b] = v
    return tab
