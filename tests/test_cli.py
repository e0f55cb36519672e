"""CLI apps (TAppEncoder/TAppDecoder analogs, utils/cli.py) with HM-style
option names and cfg files (TAppEncCfg.cpp:335-700,
program_options_lite.h)."""
import os
import subprocess
import sys

import numpy as np
import pytest

from hevc_hop_tpu.io import yuv as yuvio
from hevc_hop_tpu.utils import cli
from hevc_hop_tpu.utils.options import Options

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_options_cfg_and_cli(tmp_path):
    o = Options()
    o.add("SourceWidth,-wdt", "width", 0, "w")
    o.add("SAO", "sao", False, "sao")
    o.add("QP,-q", "qp", 32, "qp")
    cfgf = tmp_path / "t.cfg"
    cfgf.write_text("SourceWidth : 64  # comment\nSAO: 1\nUnknownKey: 3\n")
    o.parse(["-c", str(cfgf), "-q", "27"])
    assert o.values == {"width": 64, "sao": True, "qp": 27}


def test_cli_encode_decode_roundtrip(tmp_path):
    w, h = 96, 64
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (120 + 60 * np.sin(xx / 9.0)).astype(np.int32)
    cb = np.full((h // 2, w // 2), 120, np.int32)
    cr = np.full((h // 2, w // 2), 130, np.int32)
    src = tmp_path / "in.yuv"
    yuvio.write_yuv420(str(src), [(y, cb, cr)])
    bs = tmp_path / "out.bin"
    rec = tmp_path / "rec.yuv"
    rc = cli.main(["encode", "-c",
                   os.path.join(REPO, "cfg", "encoder_intra_main.cfg"),
                   "-i", str(src), "-b", str(bs), "-o", str(rec),
                   "-wdt", str(w), "-hgt", str(h), "-f", "1"])
    assert rc == 0 and bs.exists() and rec.exists()
    dec = tmp_path / "dec.yuv"
    rc = cli.main(["decode", "-b", str(bs), "-o", str(dec)])
    assert rc == 0
    assert dec.read_bytes() == rec.read_bytes()
    rc = cli.main(["bytecount", "-b", str(bs)])
    assert rc == 0


def test_cli_multi_frame_recon_equals_decode(tmp_path):
    """-f 2 -o rec writes each frame's own recon, byte-identical to what
    the decoder reconstructs from the stream."""
    w, h = 64, 64
    yy, xx = np.mgrid[0:h, 0:w]
    frames = [((100 + 50 * np.sin(xx / (5.0 + k)) * np.cos(yy / 7.0))
               .astype(np.int32),
               np.full((h // 2, w // 2), 110 + 20 * k, np.int32),
               np.full((h // 2, w // 2), 140 - 20 * k, np.int32))
              for k in range(2)]
    src = tmp_path / "in.yuv"
    yuvio.write_yuv420(str(src), frames)
    bs, rec, dec = (tmp_path / n for n in ("o.bin", "rec.yuv", "dec.yuv"))
    rc = cli.main(["encode", "-c",
                   os.path.join(REPO, "cfg", "encoder_intra_main.cfg"),
                   "-i", str(src), "-b", str(bs), "-o", str(rec),
                   "-wdt", str(w), "-hgt", str(h), "-f", "2"])
    assert rc == 0
    assert cli.main(["decode", "-b", str(bs), "-o", str(dec)]) == 0
    r = rec.read_bytes()
    assert len(r) == 2 * w * h * 3 // 2
    assert r[:len(r) // 2] != r[len(r) // 2:]
    assert dec.read_bytes() == r


def test_cli_holoscopic_cfg(tmp_path):
    w, h = 64, 64
    mi = 16
    rng = np.random.default_rng(2)
    base = rng.integers(60, 200, (mi, mi))
    y = np.tile(base, (h // mi, w // mi)).astype(np.int32)
    cb = np.full((h // 2, w // 2), 128, np.int32)
    cr = np.full((h // 2, w // 2), 128, np.int32)
    src = tmp_path / "lens.yuv"
    yuvio.write_yuv420(str(src), [(y, cb, cr)])
    bs = tmp_path / "lens.bin"
    rc = cli.main(["encode", "-c",
                   os.path.join(REPO, "cfg", "3DHencoder_intra_main.cfg"),
                   "-i", str(src), "-b", str(bs),
                   "-wdt", str(w), "-hgt", str(h), "-f", "1",
                   "-sr", "16"])
    assert rc == 0
    dec = tmp_path / "dec.yuv"
    rc = cli.main(["decode", "-b", str(bs), "-o", str(dec)])
    assert rc == 0


def test_cli_convert(tmp_path):
    w, h = 16, 16
    y = np.arange(w * h, dtype=np.int32).reshape(h, w) % 256
    cb = np.full((h // 2, w // 2), 90, np.int32)
    cr = np.full((h // 2, w // 2), 200, np.int32)
    src = tmp_path / "in8.yuv"
    yuvio.write_yuv420(str(src), [(y, cb, cr)])
    out = tmp_path / "out10.yuv"
    rc = cli.main(["convert", "-i", str(src), "-o", str(out),
                   "-wdt", str(w), "-hgt", str(h),
                   "--InputBitDepth", "8", "--OutputBitDepth", "10"])
    assert rc == 0
    (y10, cb10, cr10), = yuvio.read_yuv420(str(out), w, h, 1, 10)
    assert (y10.astype(np.int32) == (y << 2)).all()


def test_analyzer_summary():
    import contextlib
    import io
    from hevc_hop_tpu.utils.analyze import Analyzer, plane_psnr
    an = Analyzer(frame_rate=30)
    y = np.full((16, 16), 100, np.int32)
    r = y.copy()
    r[0, 0] = 104
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        an.add_picture(0, "I", 32, 8000, (y, y, y), (r, y, y),
                       verbose=True)
        an.add_picture(1, "P", 30, 4000, (y, y, y), (y, y, y))
        s = an.summary()
        an.print_summary()
    assert s["n"] == 2 and s["kbps"] == (12000 / 2) * 30 / 1000.0
    out = buf.getvalue()
    assert "I-SLICE" in out and "kbps" in out
    assert plane_psnr(y, y) == float("inf")
