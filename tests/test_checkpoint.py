"""Snapshot checkpointing: a saved+loaded engine must be indistinguishable
from a freshly built one (warm-start is a cache, never a semantic change),
and a STALE checkpoint must reconcile through the normal refresh lifecycle
— no-op / O(delta) tier / full rebuild — not serve stale results.

Reference analogue: reopen-equivalence of the on-disk index
(/root/reference/shard_test.go:40-63); the checkpoint adds the same
guarantee one level up, for the device serving tables."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from inverted_index_2_tpu import InvertedIndex
from inverted_index_2_tpu.models.checkpoint import (
    load_checkpoint,
    load_fingerprint,
    save_checkpoint,
)
from inverted_index_2_tpu.models.query_engine import (
    QueryEngine,
    _index_fingerprint,
    snapshot_tables,
)

from test_query_engine import build_index


def _assert_same_results(eng_a, eng_b, truth, extra_missing=(b"missing",)):
    terms = sorted(truth.keys()) + list(extra_missing)
    got_a = eng_a.lookup(terms)
    got_b = eng_b.lookup(terms)
    for t, a, b in zip(terms, got_a, got_b):
        if a is None:
            assert b is None, t
        else:
            assert b is not None and a.tolist() == b.tolist(), t
    # range read + prefix search parity
    ra = [(t, v.tolist()) for t, v in eng_a.read_range(None, None)]
    rb = [(t, v.tolist()) for t, v in eng_b.read_range(None, None)]
    assert ra == rb
    pa = eng_a.prefix_search([b"term0", b"nope"])
    pb = eng_b.prefix_search([b"term0", b"nope"])
    assert set(pa) == set(pb)
    for k in pa:
        assert pa[k].tolist() == pb[k].tolist()


def test_checkpoint_roundtrip_tables(tmp_path, rng):
    ii, _ = build_index(tmp_path / "idx", rng)
    path = str(tmp_path / "snap.ckpt")
    meta = save_checkpoint(ii, path)
    t_fresh = snapshot_tables(ii)
    t_loaded, meta2 = load_checkpoint(path)
    assert meta2["n_terms"] == t_fresh.n_terms == meta["n_terms"]
    for name in ("keys", "words", "flat", "tbs", "counts", "removed", "slots"):
        np.testing.assert_array_equal(
            getattr(t_loaded, name), getattr(t_fresh, name), err_msg=name
        )
    for name in ("max_probes", "max_count", "width", "max_bw"):
        assert getattr(t_loaded, name) == getattr(t_fresh, name), name
    assert load_fingerprint(meta2) == _index_fingerprint(ii, False)
    # no tmp litter after a successful publish
    assert not (tmp_path / "snap.ckpt.tmp").exists()


def test_from_checkpoint_serves_identically(tmp_path, rng):
    ii, truth = build_index(tmp_path / "idx", rng)
    ii.put_removed([3, 4])
    path = str(tmp_path / "snap.ckpt")
    save_checkpoint(ii, path)
    fresh = QueryEngine.from_index(ii, L=256)
    warm = QueryEngine.from_checkpoint(path, L=256)
    _assert_same_results(fresh, warm, truth)
    # tombstone array survived the round trip (filter_removed parity)
    f = fresh.lookup(sorted(truth.keys()), filter_removed=True)
    w = warm.lookup(sorted(truth.keys()), filter_removed=True)
    for t, a, b in zip(sorted(truth.keys()), f, w):
        assert (a is None) == (b is None), t
        if a is not None:
            assert a.tolist() == b.tolist(), t


def test_from_checkpoint_unchanged_index_is_noop(tmp_path, rng):
    ii, truth = build_index(tmp_path / "idx", rng)
    path = str(tmp_path / "snap.ckpt")
    save_checkpoint(ii, path)
    warm = QueryEngine.from_checkpoint(path, index=ii, L=256)
    assert warm.delta is None  # fingerprint matched: no refresh work
    assert warm._fingerprint == _index_fingerprint(ii, False)
    fresh = QueryEngine.from_index(ii, L=256)
    _assert_same_results(fresh, warm, truth)


def test_stale_checkpoint_additive_drift_uses_delta(tmp_path, rng):
    ii, truth = build_index(tmp_path / "idx", rng)
    path = str(tmp_path / "snap.ckpt")
    save_checkpoint(ii, path)
    # additive drift after the save: new docs only
    ii.put([b"term000", b"brandnew"], 999)
    truth.setdefault(b"term000", set()).add(999)
    truth.setdefault(b"brandnew", set()).add(999)
    warm = QueryEngine.from_checkpoint(path, index=ii, L=256)
    assert warm.delta is not None  # additive drift -> incremental tier
    for t in (b"term000", b"brandnew"):
        got = warm.lookup([t])[0]
        assert got is not None and got.tolist() == sorted(truth[t]), t
    fresh = QueryEngine.from_index(ii, L=256)
    _assert_same_results(fresh, warm, truth)


def test_stale_checkpoint_after_merge_full_rebuild(tmp_path, rng):
    ii, truth = build_index(tmp_path / "idx", rng)
    path = str(tmp_path / "snap.ckpt")
    save_checkpoint(ii, path)
    # merge away the checkpointed segments: delta precondition broken
    ii.put_removed([1, 2])
    while ii.merge(2, 100, 2) > 0:
        pass
    warm = QueryEngine.from_checkpoint(path, index=ii, L=256)
    assert warm.delta is None  # full rebuild path
    fresh = QueryEngine.from_index(ii, L=256)
    truth = {t: d for t, d in truth.items()}
    _assert_same_results(fresh, warm, truth)


def test_checkpoint_apply_removed(tmp_path, rng):
    ii, truth = build_index(tmp_path / "idx", rng, n_docs=30)
    ii.put_removed([5, 6])
    path = str(tmp_path / "snap.ckpt")
    meta = save_checkpoint(ii, path, apply_removed=True)
    assert meta["apply_removed"] is True
    warm = QueryEngine.from_checkpoint(path, index=ii, L=256)
    for t, docs in truth.items():
        want = sorted(docs - {5, 6})
        got = warm.lookup([t])[0]
        if want:
            assert got is not None and got.tolist() == want, t
        else:
            assert got is None, t


def test_checkpoint_empty_index(tmp_path):
    ii = InvertedIndex(str(tmp_path / "idx"))
    path = str(tmp_path / "snap.ckpt")
    save_checkpoint(ii, path)
    warm = QueryEngine.from_checkpoint(path, index=ii, L=256)
    assert warm.snap.n_terms == 0
    assert warm.lookup([b"anything"]) == [None]


def test_corrupt_checkpoint_raises_value_error(tmp_path, rng):
    ii, _ = build_index(tmp_path / "idx", rng, n_docs=5)
    path = str(tmp_path / "snap.ckpt")
    save_checkpoint(ii, path)
    # a foreign npz: valid archive, wrong contents
    foreign = str(tmp_path / "foreign.npz")
    np.savez(foreign, a=np.arange(3))
    with pytest.raises((ValueError, KeyError)):
        load_checkpoint(foreign)
    # truncated file: numpy raises its own error, never a wrong result
    raw = open(path, "rb").read()
    bad = str(tmp_path / "trunc.ckpt")
    open(bad, "wb").write(raw[: len(raw) // 2])
    with pytest.raises(Exception):
        load_checkpoint(bad)


def test_checkpoint_during_concurrent_writes(tmp_path):
    """save_checkpoint while writers + a merger run: pin_all freezes a
    consistent state (every seed doc present, no torn reads, loadable),
    mirroring the reference's goroutine-storm discipline
    (/root/reference/inverted_index_test.go:84-138)."""
    import threading

    ii = InvertedIndex(str(tmp_path / "idx"))
    seed_terms = [f"seed{i:02d}".encode() for i in range(8)]
    for doc in range(1, 20):
        ii.put([seed_terms[doc % 8], b"base"], doc)

    stop = threading.Event()
    errs = []

    def writer():
        doc = 1000
        try:
            while not stop.is_set():
                ii.put([seed_terms[doc % 8], f"w{doc}".encode()], doc)
                doc += 1
        except Exception as e:  # pragma: no cover
            errs.append(e)

    def merger():
        try:
            while not stop.is_set():
                ii.merge(2, 4, 1)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=writer), threading.Thread(target=merger)]
    for t in threads:
        t.start()
    paths = []
    try:
        for i in range(3):
            p = str(tmp_path / f"live{i}.ckpt")
            save_checkpoint(ii, p)
            paths.append(p)
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errs, errs

    final_truth = {}
    from inverted_index_2_tpu import to_slice

    for tv in to_slice(ii.read(None, None)):
        final_truth[tv.term] = set(tv.values.tolist())
    for p in paths:
        eng = QueryEngine.from_checkpoint(p, L=256)
        got = eng.lookup(seed_terms)
        for t, g in zip(seed_terms, got):
            assert g is not None, t
            vals = set(g.tolist())
            # every pre-storm doc present; nothing outside the final truth
            assert {d for d in range(1, 20) if seed_terms[d % 8] == t} <= vals, t
            assert vals <= final_truth[t], t


def test_auto_checkpoint_tracks_main_rebuilds(tmp_path, rng):
    """checkpoint_path keeps the warm-start file current: written at
    from_index, untouched by delta-only refreshes (reconciles at load),
    rewritten by full rebuilds and promotions."""
    ii, truth = build_index(tmp_path / "idx", rng)
    path = str(tmp_path / "auto.ckpt")
    eng = QueryEngine.from_index(
        ii, L=256, checkpoint_path=path, checkpoint_async=False
    )
    _, meta0 = load_checkpoint(path)
    assert load_fingerprint(meta0) == eng._main_fp

    # delta-only refresh: file keeps the MAIN fingerprint (stale by design)
    ii.put([b"term000", b"tiny"], 901)
    assert eng.refresh(ii) is True and eng.delta is not None
    _, meta1 = load_checkpoint(path)
    assert load_fingerprint(meta1) == eng._main_fp != eng._fingerprint
    # ... and a load still reconciles to the live state
    warm = QueryEngine.from_checkpoint(path, index=ii, L=256)
    assert warm.lookup([b"tiny"])[0].tolist() == [901]

    # compaction forces a full rebuild: the file is rewritten
    while ii.merge(2, 100, 2) > 0:
        pass
    assert eng.refresh(ii) is True and eng.delta is None
    _, meta2 = load_checkpoint(path)
    assert load_fingerprint(meta2) == _index_fingerprint(ii, False)
    warm2 = QueryEngine.from_checkpoint(path, L=256)
    truth.setdefault(b"term000", set()).add(901)
    truth.setdefault(b"tiny", set()).add(901)
    _assert_same_results(QueryEngine.from_index(ii, L=256), warm2, truth)


def test_auto_checkpoint_async_publishes_atomically(tmp_path, rng):
    ii, _ = build_index(tmp_path / "idx", rng, n_docs=20)
    path = str(tmp_path / "auto.ckpt")
    eng = QueryEngine.from_index(ii, L=256, checkpoint_path=path)
    eng.checkpoint_wait()
    _, meta = load_checkpoint(path)
    assert load_fingerprint(meta) == eng._main_fp
    import os

    assert not os.path.exists(path + ".tmp")


def test_warm_checkpoint_serves_during_upload_window(tmp_path, rng, monkeypatch):
    """from_checkpoint (warm_serve default) answers queries from the host
    tables BEFORE the device arena upload lands: every
    entry point — lookup, boolean both ops, staged incl. prefix_p
    pagination, read_range, prefix_search — is bit-identical across the
    window, and the swap publishes the full device state atomically."""
    import time
    import inverted_index_2_tpu.models.query_engine as qe_mod

    ii, truth = build_index(tmp_path / "idx", rng)
    ii.put_removed([3, 4])
    path = str(tmp_path / "snap.ckpt")
    save_checkpoint(ii, path)

    threading = __import__("threading")
    gate = threading.Event()
    orig_upload = qe_mod.upload_tables

    def gated_upload(t, chunk_bytes=None):
        # hold only the warm-start BACKGROUND upload (fresh engine builds
        # in this test go through the same module function)
        if threading.current_thread().name == "tpi-ckpt-upload":
            gate.wait(timeout=120)
        return orig_upload(t, chunk_bytes)

    monkeypatch.setattr(qe_mod, "upload_tables", gated_upload)
    warm = QueryEngine.from_checkpoint(path, L=256, q_bucket=8)
    assert not warm.device_ready()
    fresh = QueryEngine.from_index(ii, L=256)

    terms = sorted(truth.keys())
    qs = [terms[:3], terms[3:5], [b"zz-miss", terms[0]]]

    def collect(eng):
        out = {"lk": eng.lookup(terms + [b"zz-miss"]),
               "lkf": eng.lookup(terms, filter_removed=True)}
        for op in ("and", "or"):
            out[op] = eng.boolean(qs, op)
            out[op + "s"] = eng.boolean_staged([qs], op, columnar=True)
            out[op + "p"] = eng.boolean_staged([qs], op, columnar=True,
                                               prefix_p=2)
        out["rr"] = [(t, v.tolist()) for t, v in eng.read_range(None, None)]
        out["pf"] = eng.prefix_search([b"term0", b"nope"])
        return out

    def assert_equal(a, b):
        assert a["rr"] == b["rr"]
        assert set(a["pf"]) == set(b["pf"])
        for k in a["pf"]:
            assert a["pf"][k].tolist() == b["pf"][k].tolist()
        for key in ("lk", "lkf", "and", "or"):
            for x, y in zip(a[key], b[key]):
                if x is None or y is None:
                    assert x is None and y is None
                else:
                    assert np.array_equal(x, y), key
        for key in ("ands", "ors", "andp", "orp"):
            for x, y in zip(a[key][0], b[key][0]):
                assert np.array_equal(x, y), key

    window = collect(warm)
    assert not warm.device_ready()  # still inside the window
    assert_equal(window, collect(fresh))
    gate.set()
    warm.device_wait()
    assert warm.device_ready()
    after = collect(warm)
    assert_equal(window, after)
    # an unchanged index reconciles as a no-op WITHOUT waiting on the swap
    gate.clear()
    warm2 = QueryEngine.from_checkpoint(path, index=ii, L=256, q_bucket=8)
    t0 = time.monotonic()
    assert warm2.lookup([terms[0]])[0] is not None
    assert time.monotonic() - t0 < 5.0  # served inside the window
    gate.set()
    warm2.device_wait()


def test_warm_checkpoint_drift_waits_for_swap(tmp_path, rng):
    """Real index drift during the warm window reconciles AFTER the swap
    (the rebuild must base on the full device state, not the placeholder)
    and serves the drifted truth."""
    ii, truth = build_index(tmp_path / "idx", rng)
    path = str(tmp_path / "snap.ckpt")
    save_checkpoint(ii, path)
    ii.put([b"term000", b"drifted"], 999)
    warm = QueryEngine.from_checkpoint(path, index=ii, L=256, q_bucket=8)
    assert warm.device_ready()  # drift forced the wait-then-refresh
    assert warm.lookup([b"drifted"])[0].tolist() == [999]


def test_upload_tables_chunked_bit_identical(tmp_path, rng):
    """The warm-start background upload ships arrays in bounded pieces
    (GIL-handoff chunking, snapshot._dev_chunked); the resulting device
    snapshot must be bit-identical to the monolithic upload — including
    the expanded arena, whose source words arrive as a device-side
    concat of many small transfers."""
    from inverted_index_2_tpu.models.query_engine import upload_tables

    ii, _ = build_index(tmp_path, rng)
    t = snapshot_tables(ii)
    a = upload_tables(t)
    b = upload_tables(t, chunk_bytes=64)  # absurdly small: many pieces
    for name in ("keys", "blocks", "term_block_start", "counts",
                 "removed", "hash_slots"):
        va, vb = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert np.array_equal(va, vb), name
    assert a.width == b.width and a.max_probes == b.max_probes
