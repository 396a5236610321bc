"""Placement of the persistent compilation cache: JAX_COMPILATION_CACHE_DIR
when it is set, otherwise the fixed <checkout>/.jax_cache."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _cache_dir(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax, prrn_aln_tpu; print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env,
        check=True)
    return r.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("where", ["env", "checkout"])
def test_compile_cache_dir(tmp_path, where):
    if where == "env":
        assert _cache_dir(str(tmp_path)) == str(tmp_path)
    else:
        assert _cache_dir(None) == str(ROOT / ".jax_cache")
