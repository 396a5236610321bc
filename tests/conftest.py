import os

# Deterministic CPU test environment with a virtual 8-device mesh so the
# multi-device sharding paths compile and run without accelerators.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

# in case jax was imported before the environment above was set
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

from pathlib import Path  # noqa: E402

import pytest  # noqa: E402

FIX = Path(__file__).parent / "fixtures"
# the committed CET10B9 window starts at genomic position 31401 (1-based)
CET10B9_WIN = FIX / "cet10b9_win31401.fa"
CET10B9_WIN_START = 31401


@pytest.fixture(scope="session")
def cet10b9():
    """cet10b9(lo, hi) = CET10B9[lo:hi] in 0-based genomic coordinates,
    read from the committed window."""
    from prrn_aln_tpu import io
    win = io.sniff_and_read(CET10B9_WIN)[0].seq.upper()
    off = CET10B9_WIN_START - 1

    def genomic(lo, hi):
        assert off <= lo <= hi <= off + len(win), (lo, hi)
        return win[lo - off:hi - off]
    return genomic


@pytest.fixture(scope="session")
def ce13a1():
    """The ce13a1 protein of the ce13a17 family."""
    from prrn_aln_tpu import io
    return io.sniff_and_read(FIX / "ce13a1_unaligned.fa")[0].seq
