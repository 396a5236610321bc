"""prrn_aln_tpu — sequence-alignment framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of Osamu Gotoh's
``aln``/``prrn5`` suite (pairwise, group-to-group and multiple sequence
alignment with doubly-nested randomized iterative refinement): batched
anti-diagonal wavefront DP engines, device-built profile score images,
and ``jax.sharding`` data-parallel orchestration instead of pthreads.

Reference behavior studied from ogotoh/prrn_aln (see SURVEY.md); no code is
shared with the reference.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# checkout-local persistent compilation cache at a fixed path (the path is
# part of the cache key); JAX reads JAX_COMPILATION_CACHE_DIR itself, so
# when that is set no directory is configured here
CACHE_DIR = _os.path.join(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))), ".jax_cache")


def _configure_compile_cache() -> None:
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    # short-lived CLI processes repay their compiles on every run
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


_configure_compile_cache()

from . import alphabet, config, scoring  # noqa: E402,F401
