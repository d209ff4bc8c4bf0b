"""Test config: run JAX on a virtual 8-device CPU mesh.

Tests run on the CPU; sharding/mesh tests use 8 virtual CPU devices (the
analogue of the reference validating concurrency with real goroutine storms
in-process — inverted_index_test.go:84-138). The GPU is exercised by
`python chip_smoke.py` on a machine with a card, not by this suite.

The platform and the compilation cache go through jax.config.update rather
than os.environ: an interpreter that imported jax before this file (a
sitecustomize, a plugin) has already read the environment. XLA_FLAGS is the
exception: the CPU backend parses it at first backend init, which happens
after conftest runs.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

from inverted_index_2_tpu.utils.compile_cache import enable_compile_cache

# persistent XLA compile cache (entries key on HLO + compile options, so
# repeat suite runs skip every slow compile)
enable_compile_cache()

# The XLA CPU runtime JIT-allocates a few small mappings per compiled
# executable and never coalesces them; the suite compiles thousands of
# programs (hundreds of engines x shapes x 8 devices), crossing the
# kernel's default vm.max_map_count (65530) ~30 min in — at which point an
# mmap failure inside LLVM surfaces as a SIGSEGV in backend_compile_and_load
# (reproduced: map count 60.5k and climbing ~1k/min at the crash). Two
# layers of defense: raise the ceiling (best-effort; works as root), and a
# per-test relief valve below that drops the jit caches when the process
# nears the limit (clear_caches+gc took one process from 4164 to 579 maps
# after one heavy module; with the persistent cache above, recompiles are
# fast replays).
try:
    with open("/proc/sys/vm/max_map_count", "w") as f:
        f.write("1048576")
except OSError:
    pass

# The load-aware host-route fallback reads the machine's loadavg, which the
# test run itself saturates — pin it off so routing tests are deterministic
# (test_serving_routing re-enables it with a faked loadavg to test the
# policy itself).
os.environ.setdefault("TPI_HOST_BUSY_LOAD", "0")

import gc

import numpy as np
import pytest

_MAP_RELIEF_AT = 45_000


def _n_maps() -> int:
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


@pytest.fixture(autouse=True)
def _jit_map_relief():
    yield
    if _n_maps() > _MAP_RELIEF_AT:
        jax.clear_caches()
        gc.collect()


@pytest.fixture
def rng():
    return np.random.default_rng(0xC0FFEE)
