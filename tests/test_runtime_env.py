"""Where the program keeps what it builds, and which devices it uses:
the compile-cache directory, the native codec's rebuild rule, the compact
device arena, and the multi-device dryrun's device choice."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(tmp_path, monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the fixed
    <checkout>/.jax_cache."""
    import jax

    from inverted_index_2_tpu.utils import compile_cache as cc

    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    assert cc.compile_cache_dir() == want
    assert cc.enable_compile_cache() == want
    assert updates["jax_compilation_cache_dir"] == want


def test_compiled_programs_land_in_env_cache_dir(tmp_path):
    """A fresh process with JAX_COMPILATION_CACHE_DIR set writes its
    compiled programs there."""
    cache = tmp_path / "cache"
    code = textwrap.dedent("""
        import jax, jax.numpy as jnp
        from inverted_index_2_tpu.utils.compile_cache import enable_compile_cache
        print(enable_compile_cache())
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
        jax.jit(lambda x: jnp.sort(x * 3 + 1))(jnp.arange(64)).block_until_ready()
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(cache), PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(cache)
    assert cache.is_dir() and any(cache.iterdir())


def _fake_native_dir(tmp_path):
    """A native dir whose Makefile 'builds' by copying, so the rebuild rule
    is testable without a compiler."""
    d = tmp_path / "native"
    d.mkdir()
    (d / "codec.cpp").write_text("// source\n")
    (d / "Makefile").write_text(
        "libtpicodec.so: codec.cpp Makefile\n\tcp codec.cpp libtpicodec.so\n")
    return d


def test_native_rebuilds_stale_library(tmp_path):
    from inverted_index_2_tpu.codec import native

    d = _fake_native_dir(tmp_path)
    so = d / "libtpicodec.so"
    assert native._stale(str(d))                 # missing: stale
    assert native._ensure_built(str(d)) and so.exists()
    assert not native._stale(str(d))
    # a library older than its source (e.g. built elsewhere, then the
    # source changed) is rebuilt, not loaded as it is
    os.utime(so, (1_000_000, 1_000_000))
    assert native._stale(str(d))
    assert native._ensure_built(str(d))
    assert so.stat().st_mtime > 1_000_000
    assert not native._stale(str(d))


def test_native_rebuild_failure_reports(tmp_path):
    from inverted_index_2_tpu.codec import native

    d = _fake_native_dir(tmp_path)
    (d / "Makefile").write_text("libtpicodec.so: codec.cpp\n\tfalse\n")
    assert native._ensure_built(str(d)) is False


def test_upload_tables_compact_arena(rng):
    """The device arena is compact: stride = widest block + 1 slack word,
    exactly one row per block, no slack rows."""
    from inverted_index_2_tpu.models.query_engine import (
        build_host_tables, upload_tables)

    lists = [np.unique(rng.integers(0, 1 << 20, size=int(s), dtype=np.uint32))
             for s in (1, 5, 127, 128, 129, 700)]
    voffs = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(l) for l in lists], out=voffs[1:])
    blob = b"".join(f"t{i:05d}".encode() for i in range(len(lists)))
    offs = np.arange(len(lists) + 1, dtype=np.int64) * 6
    t = build_host_tables(blob, offs, np.concatenate(lists), voffs)
    snap = upload_tables(t)
    assert snap.blocks.shape == (len(t.flat), max(4, t.max_bw + 1))
    assert snap.blocks.shape[0] == int(t.tbs[-1])


def test_dryrun_multichip_uses_backend_devices(monkeypatch):
    """dryrun_multichip runs on the devices of the backend that is up and
    sets no platform itself."""
    import jax

    if REPO not in sys.path:
        monkeypatch.syspath_prepend(REPO)
    import __graft_entry__ as ge

    updates = []
    real = jax.config.update
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append(k) or real(k, v))
    ge.dryrun_multichip(2)
    assert "jax_platforms" not in updates
    assert "jax_num_cpu_devices" not in updates
    with pytest.raises(RuntimeError, match="needs 64 devices"):
        ge.dryrun_multichip(64)
