"""Mesh-sharded production encode == single-device encode, bit-exact.

Runs on the virtual 8-device CPU mesh (conftest). This is the multi-chip
analog of the reference's (nonexistent) parallel path: frame-DP x CTU-row
bands with per-step recon-halo exchange (parallel/shard_encode.py)."""
import numpy as np
import pytest

import jax

from hevc_hop_tpu.models.encoder import EncoderConfig, IntraEncoder
from hevc_hop_tpu.models.decoder import Decoder
from hevc_hop_tpu.parallel import shard_encode


def test_banded_encode_bit_identical():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mesh = shard_encode.make_mesh(8)           # (2 frames, 4 bands)
    fpar, bpar = mesh.devices.shape
    w, h = 64, bpar * 32
    cfg = EncoderConfig(width=w, height=h, qp=30, cu_log2=4,
                        deblocking=True, sao=False)
    rng = np.random.default_rng(7)
    frames = [(rng.integers(0, 256, (h, w)).astype(np.int32),
               rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32),
               rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32))
              for _ in range(fpar)]
    menc = shard_encode.MeshIntraEncoder(cfg, mesh)
    streams = menc.encode_frames(frames)

    ref = IntraEncoder(cfg)
    for f, (y, cb, cr) in enumerate(frames):
        sref = ref.encode_frame(y, cb, cr)
        assert streams[f] == sref
        ry, rcb, rcr = (np.asarray(p, np.int32)
                        for p in menc.last_recons[f])
        ty, tcb, tcr = ref.recon_yuv
        assert (ry == ty).all() and (rcb == tcb).all() and (rcr == tcr).all()
        # and the stream decodes with a verified hash
        d = Decoder()
        d.decode_stream(streams[f])
        assert d.hash_ok == [True]
