"""The one compile-cache rule (hevc_hop_tpu.compile_cache_dir)."""
import os

import pytest

import hevc_hop_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("environ,expected", [
    ({}, os.path.join(REPO, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, os.path.join(REPO, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, None),
])
def test_compile_cache_dir_rule(environ, expected):
    # set: JAX reads the variable itself and nothing else is configured
    assert hevc_hop_tpu.compile_cache_dir(environ) == expected


def test_jax_cache_is_git_ignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
