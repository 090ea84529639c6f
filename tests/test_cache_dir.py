"""Compile-cache directory rule: JAX_COMPILATION_CACHE_DIR when set,
otherwise the fixed <repo>/.jax_cache/<machine tag>."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import jax, tc2li_slam_tpu; "
         "print(jax.config.jax_compilation_cache_dir)")


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(env_dir, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "TC2LI_NO_JIT_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = out.stdout.strip().splitlines()[-1]
    if env_dir:
        assert got == str(tmp_path / env_dir)
    else:
        parent, tag = os.path.split(got)
        assert parent == os.path.join(REPO, ".jax_cache") and tag
