"""Force tests onto a virtual 8-device CPU mesh (no GPU needed, hermetic).

The platform is pinned through jax.config before any backend is
instantiated, so the suite stays on the CPU even where a GPU is present.
Tests that need the GPU carry the `gpu` marker and decide inside the test
whether one is there (see pytest.ini).
"""
import os
import resource
import sys

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")  # mute AOT-cache chatter

# The XLA CPU compiler recurses deeply on the big wavefront-scan programs
# (ss_scan.scan_encode_pss): the default 8 MiB main-thread stack overflows
# mid-compile (segfault in backend_compile_and_load late in long suite
# runs). Raising RLIMIT_STACK at runtime is NOT enough — the kernel sizes
# the main-thread stack VMA gap at exec time — so when the limit was low
# at startup we raise it and RE-EXEC this process once.
_BIG_STACK = 512 << 20   # finite: RLIM_INFINITY flips the kernel to the
#                          legacy bottom-up mmap layout, starving LLVM's
#                          JIT of address space ("Cannot allocate memory")
try:
    _soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
    _tgt = (_BIG_STACK if _hard == resource.RLIM_INFINITY
            else min(_BIG_STACK, _hard))
    if _soft != resource.RLIM_INFINITY and _soft < _tgt:
        resource.setrlimit(resource.RLIMIT_STACK, (_tgt, _hard))
        if os.environ.get("HHT_STACK_REEXEC") != "1":
            os.environ["HHT_STACK_REEXEC"] = "1"
            # sys.orig_argv preserves the real invocation (`-m pytest`)
            os.execv(sys.executable, [sys.executable] + sys.orig_argv[1:])
except (ValueError, OSError):
    pass

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8"
                           # XLA:CPU splits codegen across a thread pool
                           # whose workers carry default 8 MiB stacks; the
                           # deepest wavefront-scan programs overflow them
                           # (observed SIGSEGV in backend_compile_and_load
                           # late in one-process suite runs). Compile on
                           # the calling thread instead — the main thread's
                           # stack rlimit is raised above.
                           + " --xla_cpu_parallel_codegen_split_count=1"
                           ).strip()
# Persistent compilation cache: its directory follows the package's rule
# (hevc_hop_tpu.compile_cache_dir); here every program is cached. Writes of
# the largest wavefront-scan executables are skipped below.
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# XLA:CPU's executable.serialize() segfaults on the largest wavefront-scan
# programs (observed: Fatal Python error in
# compilation_cache.put_executable_and_time during cold-cache suite runs).
# Skip persistent-cache WRITES for those programs; everything else still
# caches, and reads are unaffected.
from jax._src import compilation_cache as _cc  # noqa: E402

_orig_put = _cc.put_executable_and_time
_NO_SERIALIZE = ("scan_encode", "scan_decode", "banded", "local")


def _safe_put(cache_key, module_name, executable, backend, compile_time):
    if any(s in module_name for s in _NO_SERIALIZE):
        return
    return _orig_put(cache_key, module_name, executable, backend,
                     compile_time)


_cc.put_executable_and_time = _safe_put


import gc  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _release_xla_code_memory():
    """XLA:CPU JITs every executable into one bounded contiguous code
    arena (contiguous_section_memory_manager); a full one-process suite
    compiles enough distinct wavefront-scan programs to exhaust it
    ("LLVM ERROR: Unable to allocate section memory!" -> abort). Dropping
    the in-process executable caches between modules keeps the arena
    bounded; the on-disk compilation cache makes re-loads cheap."""
    yield
    jax.clear_caches()
    gc.collect()
