"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusals.

On the GPU, `python chip_smoke.py` runs the same phase functions at full
size; here each runs small against the same numpy reference, so a wrong
path, argument or check shows before any chip time is spent.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def test_phase_write_path_and_from_index(tmp_path, monkeypatch):
    """Ingest + tombstones + merge through the DEVICE merge (threshold
    lowered to this corpus), read(None, None) and prefix_search equal the
    reference; QueryEngine.from_index serves the merged index exactly."""
    from inverted_index_2_tpu import shard as shard_mod
    from inverted_index_2_tpu.ops import merge as merge_mod

    monkeypatch.setattr(shard_mod, "DEVICE_MERGE_MIN_VALUES", 1_000)
    calls = []
    orig = merge_mod.merge_views_device
    monkeypatch.setattr(merge_mod, "merge_views_device",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    ii, ref = cs.phase_write_path(str(tmp_path / "idx"), n_occ=4_000, batch=1_000,
                                  extra_segments=16, extra_occ=200, vocab=500,
                                  doc_terms=10)
    assert calls, "the merge must run on the device path"
    assert len(ii._snapshot()) == 1
    assert len(ii._snapshot()[0].segments) == 1
    cs.serve_from_index(ii, ref, n_queries=200)


def test_phase_write_path_refuses_host_merge(tmp_path):
    """At the default threshold a tiny corpus would merge on the host: the
    phase refuses instead of passing without the device merge."""
    with pytest.raises(AssertionError, match="device-merge threshold"):
        cs.phase_write_path(str(tmp_path / "idx"), n_occ=1_000, batch=500,
                            extra_segments=2, extra_occ=100, vocab=100,
                            doc_terms=10)


def test_phase_serving_config5_shape():
    eng = cs.phase_serving("cpu", n_terms=3_000, mean_len=10, nb=2, Q=256)
    assert eng.tables is None  # every op was served on the device


def test_phase_postlen1k_config3_shape():
    eng = cs.phase_postlen1k("cpu", n_terms=300, mean_len=100, nb=2, Q=256,
                             L=256)
    assert eng.tables is None


def test_phase_mesh_on_four_virtual_devices(tmp_path):
    import jax

    assert len(jax.devices()) >= 4
    cs.phase_mesh(str(tmp_path / "mesh"), 4, "cpu", vocab=3_000, n_occ=8_000,
                  batch=2_000, doc_terms=10, n_queries=128)


def test_hash_routed_vocab_spans_64_shards():
    from inverted_index_2_tpu.shard import shard_key

    voc = cs._hash_routed_vocab(5_000, np.random.default_rng(0))
    assert len({shard_key(bytes(t)) for t in voc}) == 64


def test_reference_checks_catch_a_wrong_answer():
    """The checks fail on one wrong value, a wrong dtype and a wrong true
    count — a smoke run cannot pass on a near miss."""
    want = [np.array([1, 5, 9], np.uint32), np.array([], np.uint32)]
    cs.check_rows("ok", [w.copy() for w in want], want)
    with pytest.raises(AssertionError):
        cs.check_rows("value", [np.array([1, 5, 8], np.uint32), want[1]], want)
    with pytest.raises(AssertionError):
        cs.check_rows("dtype", [want[0].astype(np.int64), want[1]], want)
    vals = np.array([1, 5], np.uint32)
    with pytest.raises(AssertionError, match="true counts"):
        cs.check_paged("count", (vals, np.array([0, 2, 2]), np.array([2, 0])),
                       want, 2)


def test_main_refuses_cpu_backend(capsys):
    """No GPU: non-zero exit, and no `ok` line."""
    rc = cs.main([])
    out = capsys.readouterr()
    assert rc != 0
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


def test_script_alone_fails(tmp_path):
    """chip_smoke.py copied into a directory with nothing else of the repo
    exits non-zero and prints no `ok` line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
