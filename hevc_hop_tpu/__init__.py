"""hevc_hop_tpu — an HEVC Main/Main10 encode/decode engine in JAX with HOP
(high-order prediction) lenslet light-field tools.

Capability reference: zinsayon/HEVC-HOP (HM 16.x + IT/Lisbon self-similarity
+ geometric-transform extensions). This is NOT a port: the compute path is
expressed as batched, jittable tensor programs (dense per-depth mode
evaluation, wavefront diagonal scheduling, integer matmul transforms) in
plain jax.numpy/lax compiled by XLA, with a native C++ CABAC runtime for the
serial entropy tail.

Layout:
  common/    ROM tables, constants, enums         (ref: TLibCommon/TComRom, TypeDef)
  ops/       jittable compute kernels             (ref: TComTrQuant, TComPrediction, ...)
  entropy/   CABAC engine + syntax coding         (ref: TEncSbac/TDecSbac, ContextTables)
  bitstream/ NAL / RBSP / parameter sets          (ref: TComBitStream, NAL, TEncCavlc)
  models/    encoder/decoder pipelines            (ref: TEncTop/TEncGOP/TEncCu, TDecTop)
  parallel/  mesh-sharded encode                  (ref: WPP/tiles constructs)
  io/        YUV file I/O, picture hashes         (ref: TLibVideoIO, TComPicYuvMD5)
  utils/     config system, CLI                   (ref: TAppCommon/program_options_lite)
  native/    C++ runtime sources (CABAC engine)
"""

import os as _os

__version__ = "0.1.0"

_REPO = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir(environ=_os.environ) -> str | None:
    """Persistent XLA compile-cache directory to configure, or None.

    The wavefront scan programs take minutes to compile, so every process
    (tests, CLI, bench, chip smoke) shares one on-disk cache. Where
    JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
    configured here (None); otherwise the cache is the fixed, git-ignored
    <repo>/.jax_cache (a fixed path: the path is part of the cache key)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _os.path.join(_REPO, ".jax_cache")


_cache_dir = compile_cache_dir()
if _cache_dir is not None:
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", _cache_dir)
