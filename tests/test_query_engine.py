"""QueryEngine (device snapshot) vs. host-iterator oracle — the differential
harness of SURVEY §7 step 7: the same index is read through the streaming host
path and through the device batch path; result sets must be identical."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from inverted_index_2_tpu import InvertedIndex, to_slice
from inverted_index_2_tpu.models import query_engine as qe_mod
from inverted_index_2_tpu.models import staged as staged_mod
from inverted_index_2_tpu.models.query_engine import QueryEngine, snapshot_index


def build_index(tmp_path, rng, n_docs=60, n_terms=40):
    ii = InvertedIndex(str(tmp_path))
    vocab = [f"term{i:03d}".encode() for i in range(n_terms)] + [b"a", b"", b"\xff\xff"]
    truth = {}
    for doc in range(1, n_docs + 1):
        k = int(rng.integers(1, 6))
        terms = [vocab[i] for i in rng.choice(len(vocab), size=k, replace=False)]
        ii.put(terms, doc)
        for t in terms:
            truth.setdefault(t, set()).add(doc)
    return ii, truth


def test_lookup_matches_host_read(tmp_path, rng):
    ii, truth = build_index(tmp_path, rng)
    eng = QueryEngine.from_index(ii, L=256)
    terms = sorted(truth.keys()) + [b"missing", b"zzzz"]
    got = eng.lookup(terms)
    for t, g in zip(terms, got):
        if t in truth:
            assert g is not None and g.tolist() == sorted(truth[t]), t
        else:
            assert g is None, t


def test_lookup_after_merge_and_remove(tmp_path, rng):
    ii, truth = build_index(tmp_path, rng)
    ii.put_removed([1, 2, 3])
    while ii.merge(2, 100, 2) > 0:
        pass
    # oracle: host read stream
    host = {tv.term: tv.values.tolist() for tv in to_slice(ii.read(None, None))}
    eng = QueryEngine.from_index(ii, L=256)
    got = eng.lookup(sorted(host.keys()))
    for t, g in zip(sorted(host.keys()), got):
        assert g.tolist() == host[t], t


def test_apply_removed_at_build(tmp_path, rng):
    ii, truth = build_index(tmp_path, rng, n_docs=30)
    ii.put_removed([5, 6])
    eng = QueryEngine.from_index(ii, L=256, apply_removed=True)
    for t, docs in truth.items():
        want = sorted(docs - {5, 6})
        got = eng.lookup([t])[0]
        if want:
            assert got is not None and got.tolist() == want, t
        else:
            assert got is None or len(got) == 0


def test_boolean_and_or(tmp_path, rng):
    ii, truth = build_index(tmp_path, rng, n_docs=80)
    eng = QueryEngine.from_index(ii, L=256)
    vocab = sorted(truth.keys())
    queries = []
    for _ in range(25):
        k = int(rng.integers(2, 5))
        queries.append([vocab[i] for i in rng.choice(len(vocab), size=k, replace=False)])
    queries.append([vocab[0], b"missing-term"])

    got_and = eng.boolean(queries, op="and")
    got_or = eng.boolean(queries, op="or")
    for q, ga, go in zip(queries, got_and, got_or):
        sets = [truth.get(t, set()) for t in q]
        want_and = set.intersection(*sets) if sets else set()
        want_or = set.union(*sets)
        assert ga.tolist() == sorted(want_and), q
        assert go.tolist() == sorted(want_or), q


def test_boolean_filter_removed(tmp_path, rng):
    ii, truth = build_index(tmp_path, rng, n_docs=40)
    ii.put_removed([7, 8, 9])
    eng = QueryEngine.from_index(ii, L=256)
    vocab = sorted(truth.keys())
    q = [vocab[:2], vocab[2:5]]
    got = eng.boolean(q, op="or", filter_removed=True)
    for terms, g in zip(q, got):
        want = sorted(set.union(*[truth.get(t, set()) for t in terms]) - {7, 8, 9})
        assert g.tolist() == want


def test_prefix_search_matches_host(tmp_path, rng):
    ii = InvertedIndex(str(tmp_path))
    ii.put([b"apple", b"apricot", b"banana", b"band", b"bandana"], 1)
    ii.put([b"applesauce", b"banjo"], 2)
    eng = QueryEngine.from_index(ii, L=128)
    prefixes = [b"ap", b"ban", b"band", b"zzz", b"apple"]
    want = ii.prefix_search(prefixes)
    got = eng.prefix_search(prefixes)
    assert set(got.keys()) == set(want.keys())
    for p in want:
        assert got[p].tolist() == want[p].tolist(), p


def test_empty_index_engine(tmp_path):
    ii = InvertedIndex(str(tmp_path))
    eng = QueryEngine.from_index(ii)
    assert eng.lookup([b"x"]) == [None]
    assert eng.prefix_search([b"x"]) == {}
    assert [g.tolist() for g in eng.boolean([[b"x", b"y"]], op="and")] == [[]]


def test_read_range_matches_host(tmp_path, rng):
    ii, truth = build_index(tmp_path, rng, n_docs=40)
    eng = QueryEngine.from_index(ii, L=256)
    host = [(tv.term, tv.values.tolist()) for tv in to_slice(ii.read(b"term01", b"term02"))]
    dev = [(t, v.tolist()) for t, v in eng.read_range(b"term01", b"term02")]
    assert dev == host
    host_all = [(tv.term, tv.values.tolist()) for tv in to_slice(ii.read(None, None))]
    dev_all = [(t, v.tolist()) for t, v in eng.read_range(None, None)]
    assert dev_all == host_all


def test_lookup_longer_than_L_is_exact(tmp_path):
    """Posting lists longer than the engine's pad length L must still return
    complete results (device-exact ladder re-serve, not silent truncation)."""
    ii = InvertedIndex(str(tmp_path))
    for v in range(1, 300):  # b"big" accumulates 299 values; L=128 below
        ii.put([b"big", f"f{v:03d}".encode()], v)
    while ii.merge(2, 1000, 2) > 0:
        pass
    eng = QueryEngine.from_index(ii, L=128)
    got = eng.lookup([b"big", b"f005"])
    assert got[0].tolist() == list(range(1, 300))
    assert got[1].tolist() == [5]


def test_boolean_longer_than_L_is_exact(tmp_path):
    """AND/OR over a posting list longer than L must re-serve exactly at a
    larger ladder L, not silently intersect truncated lists."""
    ii = InvertedIndex(str(tmp_path))
    for v in range(1, 300):
        ii.put([b"big", b"other"] if v % 7 == 0 else [b"big"], v)
    while ii.merge(2, 1000, 2) > 0:
        pass
    eng = QueryEngine.from_index(ii, L=128)
    want_other = [v for v in range(1, 300) if v % 7 == 0]
    got_and = eng.boolean([[b"big", b"other"]], op="and")[0]
    assert got_and.tolist() == want_other  # matches live above 128 too
    got_or = eng.boolean([[b"big", b"other"]], op="or")[0]
    assert got_or.tolist() == list(range(1, 300))


def test_refresh_rederives_width(tmp_path):
    """refresh() must not force the old key width (longer new terms would
    alias)."""
    ii = InvertedIndex(str(tmp_path))
    ii.put([b"ab"], 1)
    eng = QueryEngine.from_index(ii, L=128)
    ii.put([b"abcdefgh-long1"], 2)
    ii.put([b"abcdefgh-long2"], 3)
    eng.refresh(ii)
    got = eng.lookup([b"abcdefgh-long1", b"abcdefgh-long2"])
    assert got[0].tolist() == [2]
    assert got[1].tolist() == [3]


def test_failed_merge_releases_claims(tmp_path, monkeypatch):
    """A merge that raises must unclaim its segments so compaction can retry
    (otherwise one transient failure strands them forever)."""
    from inverted_index_2_tpu import Shard
    import inverted_index_2_tpu.shard as shard_mod

    sh = Shard(str(tmp_path / "s"))
    sh.put([b"t1"], 1)
    sh.put([b"t1"], 2)

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(shard_mod, "merge_views", boom)
    with pytest.raises(RuntimeError):
        sh.merge(2, 10)
    monkeypatch.undo()
    assert all(not seg.merging for seg in sh.segments.snapshot())
    assert sh.merge(2, 10) == 2  # retry succeeds


def test_very_long_terms(tmp_path):
    """Terms far wider than the common case (100+ bytes -> ~26 key words)
    through the full pipeline: ingest, merge, device lookup, prefix."""
    ii = InvertedIndex(str(tmp_path))
    long1 = b"x" * 100 + b"-one"
    long2 = b"x" * 100 + b"-two"
    ii.put([long1, b"short"], 1)
    ii.put([long2], 2)
    ii.put([long1], 3)
    while ii.merge(2, 10, 2) > 0:
        pass
    host = {tv.term: tv.values.tolist() for tv in to_slice(ii.read(None, None))}
    assert host[long1] == [1, 3] and host[long2] == [2]
    eng = QueryEngine.from_index(ii, L=128)
    got = eng.lookup([long1, long2, b"short", b"x" * 100])
    assert got[0].tolist() == [1, 3]
    assert got[1].tolist() == [2]
    assert got[2].tolist() == [1]
    assert got[3] is None  # proper prefix of a long term is NOT a match
    pref = eng.prefix_search([b"x" * 100])
    assert pref[b"x" * 100].tolist() == [1, 2, 3]


def test_lookup_filter_removed(tmp_path):
    ii = InvertedIndex(str(tmp_path))
    ii.put([b"t"], 1)
    ii.put([b"t"], 2)
    ii.put([b"t"], 3)
    ii.put_removed([2])
    eng = QueryEngine.from_index(ii, L=128)
    assert eng.lookup([b"t"])[0].tolist() == [1, 2, 3]  # parity: reads don't filter
    assert eng.lookup([b"t"], filter_removed=True)[0].tolist() == [1, 3]


def test_refresh_noop_detection(tmp_path):
    ii = InvertedIndex(str(tmp_path))
    ii.put([b"a"], 1)
    eng = QueryEngine.from_index(ii)
    assert eng.refresh(ii) is False  # from_index recorded the fingerprint
    ii.put([b"b"], 2)
    assert eng.refresh(ii) is True
    assert eng.refresh(ii) is False  # unchanged -> no rebuild
    assert eng.lookup([b"b"])[0].tolist() == [2]


def test_ladder_multi_level_and_no_host_mirror(tmp_path):
    """Long lists spanning several ladder levels (L, 8L, ...) serve exactly,
    fully on device: the snapshot holds NO host mirror of postings/terms."""
    import numpy as np

    from inverted_index_2_tpu.models.query_engine import snapshot_index

    ii = InvertedIndex(str(tmp_path))
    widths = {b"w128": 100, b"w1k": 900, b"w8k": 4321}
    blob_terms = list(widths)
    for v in range(1, 4322):
        terms = [t for t, n in widths.items() if v <= n]
        if terms:
            ii.put(terms, v)
    while ii.merge(2, 10000, 2) > 0:
        pass
    snap = snapshot_index(ii)
    assert not hasattr(snap, "host_values")
    assert snap.max_count == 4321
    eng = QueryEngine(snap, L=128)
    assert eng._levels() == [512, 2048, 4352]  # 4x steps, rounded-up max
    got = eng.lookup(blob_terms)
    assert got[0].tolist() == list(range(1, 101))
    assert got[1].tolist() == list(range(1, 901))
    assert got[2].tolist() == list(range(1, 4322))
    # boolean across levels
    res = eng.boolean([[b"w8k", b"w1k"], [b"w8k", b"w128"]], op="and")
    assert res[0].tolist() == list(range(1, 901))
    assert res[1].tolist() == list(range(1, 101))
    res = eng.boolean([[b"w1k", b"w8k"]], op="or")
    assert res[0].tolist() == list(range(1, 4322))
    # prefix + range read decode the long rows exactly too (mirror-free)
    pf = eng.prefix_search([b"w"])
    assert pf[b"w"].tolist() == list(range(1, 4322))
    rr = {t: v.tolist() for t, v in eng.read_range(None, None)}
    assert rr[b"w8k"] == list(range(1, 4322))
    assert rr[b"w128"] == list(range(1, 101))
    # memory accounting exists and is host-mirror-free: a bare-snapshot
    # engine holds NO retained tables, so host serving reports unavailable
    st = eng.stats()
    assert st["host_bytes"] <= 4 * st["n_terms"]
    assert not st["host_serving"] and st["tables_bytes"] == 0
    # retained tables (from_index keep_tables default) are reported, and
    # building without them zeroes the counter and disables the host route
    st2 = QueryEngine.from_index(ii, L=128).stats()
    assert st2["host_serving"] and st2["tables_bytes"] > 0
    st3 = QueryEngine.from_index(ii, L=128, keep_tables=False).stats()
    assert not st3["host_serving"] and st3["tables_bytes"] == 0


def test_incremental_refresh_delta(tmp_path):
    """Additive changes refresh as an O(delta) DELTA snapshot: main tables
    untouched, results identical to a full rebuild (union across tiers for
    lookup/boolean/prefix/read_range)."""
    import numpy as np

    ii = InvertedIndex(str(tmp_path))
    for v in range(1, 50):
        ii.put([b"alpha", b"beta", f"t{v:03d}".encode()], v)
    eng = QueryEngine.from_index(ii, L=128)
    main_before = eng.snap
    # additive change: same term gains values, plus a brand-new LONGER term
    ii.put([b"alpha", b"gamma-very-long-term"], 100)
    ii.put([b"beta"], 101)
    assert eng.refresh(ii) is True
    assert eng.snap is main_before, "main must not rebuild on additive change"
    assert eng.delta is not None and eng.delta.n_terms == 3
    # lookup unions across tiers
    assert eng.lookup([b"alpha"])[0].tolist() == list(range(1, 50)) + [100]
    assert eng.lookup([b"gamma-very-long-term"])[0].tolist() == [100]
    # boolean (dual program): AND across a main-only and a both-tier term
    res = eng.boolean([[b"alpha", b"beta"], [b"alpha", b"gamma-very-long-term"]], op="and")
    assert res[0].tolist() == list(range(1, 50))  # 100 vs 101 don't intersect
    assert res[1].tolist() == [100]
    res = eng.boolean([[b"beta", b"gamma-very-long-term"]], op="or")
    assert res[0].tolist() == list(range(1, 50)) + [100, 101]
    # prefix + range read union across tiers
    assert eng.prefix_search([b"gamma"])[b"gamma"].tolist() == [100]
    assert eng.prefix_search([b"alpha"])[b"alpha"].tolist() == list(range(1, 50)) + [100]
    rr = {t: v.tolist() for t, v in eng.read_range(b"alpha", b"beta")}
    assert rr[b"alpha"] == list(range(1, 50)) + [100]
    assert rr[b"beta"] == list(range(1, 50)) + [101]
    assert [t for t, _ in eng.read_range(None, None)] == sorted(
        [b"alpha", b"beta", b"gamma-very-long-term"] + [f"t{v:03d}".encode() for v in range(1, 50)]
    )
    # equivalence with a full rebuild
    full = QueryEngine.from_index(ii, L=128)
    assert full.lookup([b"alpha"])[0].tolist() == eng.lookup([b"alpha"])[0].tolist()

    # compaction removes segments -> promotes to a full rebuild
    while ii.merge(2, 1000, 2) > 0:
        pass
    assert eng.refresh(ii) is True
    assert eng.delta is None
    assert eng.snap is not main_before
    assert eng.lookup([b"alpha"])[0].tolist() == list(range(1, 50)) + [100]


def test_incremental_refresh_promotes_on_big_delta(tmp_path):
    ii = InvertedIndex(str(tmp_path))
    for v in range(1, 20):
        ii.put([f"base{v:03d}".encode()], v)
    eng = QueryEngine.from_index(ii, L=128)
    main_before = eng.snap
    for v in range(1, 20):  # delta as big as main: must promote
        ii.put([f"newt{v:03d}".encode()], 100 + v)
    assert eng.refresh(ii) is True
    assert eng.delta is None and eng.snap is not main_before
    assert eng.lookup([b"newt005"])[0].tolist() == [105]


def test_promotion_merges_snapshots_bit_identical(tmp_path):
    """Delta promotion folds the two SNAPSHOT tiers directly (no segment
    re-read) and must be bit-identical to a from-disk rebuild — tables AND
    serving results."""
    import numpy as np

    rng = np.random.default_rng(5)
    ii = InvertedIndex(str(tmp_path))
    vocab = [f"w{i:04d}".encode() for i in range(40)]
    for doc in range(1, 200):
        ts = [vocab[j] for j in rng.choice(len(vocab), size=3, replace=False)]
        ii.put(ts, doc)
    ii.put_removed([7, 13])
    eng = QueryEngine.from_index(ii, L=128)
    main_before = eng.snap
    # shared terms gain values AND brand-new longer terms appear, sized to
    # exceed DELTA_FRACTION -> the refresh takes the promotion path
    for doc in range(500, 520):
        ii.put([vocab[0], vocab[1], f"zz-long-new-term{doc}".encode()], doc)
    assert eng.refresh(ii) is True
    assert eng.delta is None and eng.snap is not main_before

    full = QueryEngine.from_index(ii, L=128)
    a, b = eng.snap, full.snap
    assert np.array_equal(np.asarray(a.keys), np.asarray(b.keys))
    assert np.array_equal(np.asarray(a.counts), np.asarray(b.counts))
    assert np.array_equal(np.asarray(a.blocks), np.asarray(b.blocks))
    assert np.array_equal(np.asarray(a.removed), np.asarray(b.removed))
    terms = vocab[:8] + [b"zz-long-new-term505"]
    for filt in (False, True):
        ra = eng.lookup(terms, filter_removed=filt)
        rb = full.lookup(terms, filter_removed=filt)
        for x, y in zip(ra, rb):
            assert (x is None and y is None) or np.array_equal(x, y)
    qa = eng.boolean([[vocab[0], vocab[1]]], "and", filter_removed=True)
    qb = full.boolean([[vocab[0], vocab[1]]], "and", filter_removed=True)
    assert np.array_equal(qa[0], qb[0])


def test_promotion_apply_removed_bit_identical(tmp_path):
    """Promotion under apply_removed (purged main + purged delta, unchanged
    tombstones) matches a purged from-disk rebuild."""
    import numpy as np

    ii = InvertedIndex(str(tmp_path))
    for v in range(1, 30):
        ii.put([b"common", f"t{v:03d}".encode()], v)
    ii.put_removed([3, 4])
    eng = QueryEngine.from_index(ii, L=128, apply_removed=True)
    for v in range(100, 120):  # oversized delta -> promotion
        ii.put([b"common", f"n{v}".encode()], v)
    assert eng.refresh(ii, apply_removed=True) is True
    assert eng.delta is None
    full = QueryEngine.from_index(ii, L=128, apply_removed=True)
    assert np.array_equal(np.asarray(eng.snap.keys), np.asarray(full.snap.keys))
    assert np.array_equal(np.asarray(eng.snap.counts), np.asarray(full.snap.counts))
    got = eng.lookup([b"common"])[0].tolist()
    assert got == full.lookup([b"common"])[0].tolist()
    assert 3 not in got and 4 not in got


def test_incremental_refresh_tombstones(tmp_path):
    """filter_removed sees tombstones added after a delta refresh (the
    engine-level removed array refreshes even when tables do not)."""
    ii = InvertedIndex(str(tmp_path))
    ii.put([b"k1", b"k2"], 1)
    ii.put([b"k1"], 2)
    eng = QueryEngine.from_index(ii, L=128)
    ii.put([b"k3"], 3)
    ii.put_removed([1])
    assert eng.refresh(ii) is True
    assert eng.lookup([b"k1"], filter_removed=True)[0].tolist() == [2]
    assert eng.lookup([b"k2"], filter_removed=True)[0] is None or \
        eng.lookup([b"k2"], filter_removed=True)[0].tolist() == []
    assert eng.lookup([b"k3"])[0].tolist() == [3]


def test_refresh_concurrent_with_writers(tmp_path):
    """Delta refreshes racing live writers + a merger must stay exact: the
    serve/refresh lifecycle analogue of the reference's goroutine storms
    (inverted_index_test.go:84-138)."""
    import threading

    ii = InvertedIndex(str(tmp_path))
    ii.put([b"seed"], 1)
    eng = QueryEngine.from_index(ii, L=128)
    stop = threading.Event()
    errors = []

    def writer(base):
        v = base
        while not stop.is_set():
            v += 1
            ii.put([f"w{base}-{v % 37:02d}".encode()], v)

    def merger():
        while not stop.is_set():
            ii.merge(2, 100, 2)

    threads = [threading.Thread(target=writer, args=(b,)) for b in (1000, 2000)]
    threads.append(threading.Thread(target=merger))
    for t in threads:
        t.start()
    try:
        for _ in range(15):
            eng.refresh(ii)  # mixes delta and full rebuilds under churn
            got = eng.lookup([b"seed"])[0]
            assert got is not None and got.tolist() == [1]
    finally:
        stop.set()
        for t in threads:
            t.join()
    # final: a quiesced refresh matches the host read exactly
    eng.refresh(ii)
    host = {tv.term: tv.values.tolist() for tv in to_slice(ii.read(None, None))}
    terms = sorted(host.keys())
    got = eng.lookup(terms)
    for t, g in zip(terms, got):
        assert g is not None and g.tolist() == host[t], t


def test_boolean_concat_fuzz(tmp_path, rng):
    """Fuzz the concat-decode boolean path (work sized by real postings):
    mixed list lengths spanning several block classes, missing terms,
    genuine 0xFFFFFFFF members, 1..6-term queries, AND + OR, with and
    without tombstone filtering."""
    ii = InvertedIndex(str(tmp_path))
    truth = {}
    vocab = []
    for i in range(30):
        t = f"t{i:02d}".encode()
        vocab.append(t)
        n = int(rng.integers(1, 700))
        vals = np.unique(rng.integers(0, 5000, size=n, dtype=np.uint32))
        if i % 7 == 0:
            vals = np.unique(np.concatenate([vals, [0xFFFFFFFF]])).astype(np.uint32)
        truth[t] = set(int(v) for v in vals)
        for v in vals:
            ii.put([t], int(v))
    while ii.merge(2, 10000, 2) > 0:
        pass
    eng = QueryEngine.from_index(ii, L=128)
    queries = []
    for _ in range(40):
        k = int(rng.integers(1, 7))
        q = [vocab[i] for i in rng.choice(len(vocab), size=k, replace=False)]
        if rng.random() < 0.2:
            q[-1] = b"missing-term"
        queries.append(q)
    for op in ("and", "or"):
        got = eng.boolean(queries, op=op)
        for q, g in zip(queries, got):
            sets = [truth.get(t, set()) for t in q]
            want = set.intersection(*sets) if op == "and" else set.union(*sets)
            assert g.tolist() == sorted(want), (op, q)
    rm = [int(v) for v in rng.integers(0, 5000, size=50)]
    ii.put_removed(rm)
    eng.refresh(ii)
    got = eng.boolean(queries[:10], op="or", filter_removed=True)
    for q, g in zip(queries[:10], got):
        want = set.union(*[truth.get(t, set()) for t in q]) - set(rm)
        assert g.tolist() == sorted(want), q


def test_delta_refresh_apply_removed_purges(tmp_path):
    """Under apply_removed=True, a delta refresh must purge the NEW segments
    against the (unchanged) tombstones — an unpurged delta would resurrect
    removed values that a full rebuild of the same state purges."""
    ii = InvertedIndex(str(tmp_path))
    ii.put([b"k1", b"k2"] + [f"fill{i:02d}".encode() for i in range(20)], 1)
    ii.put([b"k1"], 7)
    ii.put_removed([7])
    eng = QueryEngine.from_index(ii, L=128, apply_removed=True)
    assert eng.lookup([b"k1"])[0].tolist() == [1]
    main_before = eng.snap
    ii.put([b"k1", b"k3"], 7)  # value 7 re-enters via a NEW segment
    assert eng.refresh(ii, apply_removed=True) is True
    assert eng.snap is main_before  # main untouched (delta path taken)
    # the new segment purges to NOTHING -> delta rightly collapses to None
    full = QueryEngine.from_index(ii, L=128, apply_removed=True)
    assert eng.lookup([b"k1"])[0].tolist() == full.lookup([b"k1"])[0].tolist() == [1]
    assert eng.lookup([b"k3"])[0] is None and full.lookup([b"k3"])[0] is None

    # partial survival: the delta keeps 8 but must NOT resurrect 7
    ii.put([b"k1", b"k3"], 8)
    assert eng.refresh(ii, apply_removed=True) is True
    assert eng.snap is main_before and eng.delta is not None
    full = QueryEngine.from_index(ii, L=128, apply_removed=True)
    assert eng.lookup([b"k1"])[0].tolist() == full.lookup([b"k1"])[0].tolist() == [1, 8]
    assert eng.lookup([b"k3"])[0].tolist() == full.lookup([b"k3"])[0].tolist() == [8]
    got = eng.boolean([[b"k1", b"k3"]], op="and")[0]
    assert got.tolist() == [8]


def test_warmup_compiles_serving_programs(tmp_path):
    ii = InvertedIndex(str(tmp_path))
    for v in range(1, 30):
        ii.put([f"w{v:02d}".encode()], v)
    eng = QueryEngine.from_index(ii, L=128)
    n = eng.warmup(k_max=4)
    assert n >= 3  # lookup + resolve + at least one boolean class
    # serving still exact after warmup
    assert eng.lookup([b"w05"])[0].tolist() == [5]
    assert eng.boolean([[b"w05", b"w06"]], op="or")[0].tolist() == [5, 6]


def test_boolean_staged_concat_stream(tmp_path, rng):
    """Staged OR (depth-pipelined concat-stream) is result-identical to
    boolean() per batch — and AND streams through the same path. prefix_p mode returns TRUE counts plus the first-P
    values per query (the pagination contract)."""
    ii, truth = build_index(tmp_path, rng, n_docs=120)
    ii.put_removed(np.asarray([3, 17], dtype=np.uint32))
    eng = QueryEngine.from_index(ii, L=128, q_bucket=8)
    vocab = sorted(truth.keys())
    rq = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        qs = []
        for _ in range(7):
            k = int(rq.integers(1, 5))
            qs.append(
                [vocab[i] for i in rq.choice(len(vocab), size=k, replace=False)]
            )
        batches.append(qs)
    batches[1].append([vocab[0], b"zz-missing"])
    batches.append([])  # empty batch mid-stream keeps positions aligned
    for op in ("or", "and"):
        for fr in (False, True):
            staged = eng.boolean_staged(batches, op, filter_removed=fr)
            col = eng.boolean_staged(batches, op, filter_removed=fr,
                                     columnar=True)
            pre = eng.boolean_staged(batches, op, filter_removed=fr,
                                     columnar=True, prefix_p=3)
            for bi, qs in enumerate(batches):
                plain = eng.boolean(qs, op, filter_removed=fr)
                vals, voffs = col[bi]
                pv, pvo, pc = pre[bi]
                assert len(voffs) == len(qs) + 1
                assert len(pvo) == len(qs) + 1 and len(pc) == len(qs)
                for qi in range(len(qs)):
                    assert np.array_equal(staged[bi][qi], plain[qi]), (op, bi, qi)
                    assert np.array_equal(
                        vals[voffs[qi]: voffs[qi + 1]], plain[qi]
                    ), (op, bi, qi)
                    assert pc[qi] == len(plain[qi]), (op, bi, qi)
                    assert np.array_equal(
                        pv[pvo[qi]: pvo[qi + 1]], plain[qi][:3]
                    ), (op, bi, qi)


def test_boolean_staged_prefix_requires_columnar(tmp_path):
    ii = InvertedIndex(str(tmp_path))
    ii.put([b"aa"], 1)
    eng = QueryEngine.from_index(ii, L=128)
    with pytest.raises(ValueError):
        eng.boolean_staged([[[b"aa"]]], "or", prefix_p=4)


def test_boolean_staged_prefix_fallback_with_delta(tmp_path):
    """With a delta tier live the prefix_p mode serves through the exact
    per-batch fallback — same (values, voffs, counts) contract."""
    ii = InvertedIndex(str(tmp_path))
    for v in range(1, 40):
        ii.put([b"aa", f"b{v:02d}".encode()], v)
    eng = QueryEngine.from_index(ii, L=128, q_bucket=8)
    ii.put([b"aa", b"zz"], 99)
    assert eng.refresh(ii) is True and eng.delta is not None
    out = eng.boolean_staged([[[b"aa"], [b"aa", b"zz"]]], "or",
                             columnar=True, prefix_p=4)
    (pv, pvo, pc), = out
    plain = eng.boolean([[b"aa"], [b"aa", b"zz"]], "or")
    assert pc[0] == len(plain[0]) and pc[1] == len(plain[1])
    assert np.array_equal(pv[pvo[0]: pvo[1]], plain[0][:4])
    assert np.array_equal(pv[pvo[1]: pvo[2]], plain[1][:4])


def test_staged_prefix_pagination_full_bucket(tmp_path):
    """Regression (advisor round 4): nq an exact multiple of q_bucket with
    a PADDED class chunk. The pagination scatter's -1 selector pads used
    to be normalized to row QB-1 before mode="drop" (JAX wraps negative
    indices first), so a padded chunk dispatched after the last query's
    own chunk silently overwrote that query's page with an empty pad row
    — query QB-1 returned count 0. Pads must scatter genuinely
    out-of-bounds (models/steps.py _scatter_p_step)."""
    ii = InvertedIndex(str(tmp_path))
    docs = []
    vocab = [f"t{i:02d}".encode() for i in range(20)]
    for i, t in enumerate(vocab):
        docs += [([t], v) for v in range(1, 10 + i)]
    # query index 7's term: true count 48 — the victim row
    docs += [([b"sm"], v) for v in range(1, 49)]
    ii.put_many(docs)
    eng = QueryEngine.from_index(ii, L=8, q_bucket=8)
    # queries 0-6: 9 terms each -> block sum 9 -> SB class 32, one chunk of
    # 7 members + 1 PAD, dispatched AFTER query 7's class-8 chunk (classes
    # run SB-ascending) — with the bug the pad lane clobbered row 7.
    batch = [vocab[i: i + 9] for i in range(7)] + [[b"sm"]]
    assert len(batch) == 8  # nq == q_bucket exactly
    for op in ("or", "and"):
        (pv, pvo, pc), = eng.boolean_staged([batch], op, columnar=True,
                                            prefix_p=4)
        plain = eng.boolean(batch, op)
        assert pc[7] == 48, "padded chunk clobbered the last query's row"
        for qi in range(8):
            assert pc[qi] == len(plain[qi]), (op, qi)
            assert np.array_equal(pv[pvo[qi]: pvo[qi + 1]],
                                  plain[qi][:4]), (op, qi)
    # the staged lookup stream shares the same scatter
    (pv, pvo, pc), = eng.lookup_staged(
        [vocab[:7] + [b"sm"]], columnar=True, prefix_p=4)
    assert pc[7] == 48 and np.array_equal(pv[pvo[7]: pvo[8]],
                                          np.arange(1, 5, dtype=np.uint32))


def test_boolean_delegates_to_staged_at_bulk_q(tmp_path, rng, monkeypatch):
    """One-shot boolean() at bulk Q on the DEVICE route delegates to the
    staged stream — same contract, pipelined machinery —
    and stays bit-identical to the direct path, tombstones and delta tier
    included."""
    ii, truth = build_index(tmp_path, rng)
    ii.put_removed(np.asarray([2, 9], dtype=np.uint32))
    eng = QueryEngine.from_index(ii, L=128, q_bucket=8)
    monkeypatch.setenv("TPI_HOST_BOOL", "0")  # pin the device route
    monkeypatch.setattr(QueryEngine, "_STAGED_DELEGATE_MIN", 16)
    vocab = sorted(truth.keys())
    rq = np.random.default_rng(3)
    qs = [
        [vocab[i] for i in rq.choice(len(vocab),
                                     size=int(rq.integers(1, 4)),
                                     replace=False)]
        for _ in range(20)
    ] + [[b"zz-missing", vocab[0]]]
    called = []
    orig = QueryEngine.boolean_staged

    def spy(self, batches, *a, **kw):
        called.append(len(batches))
        return orig(self, batches, *a, **kw)

    monkeypatch.setattr(QueryEngine, "boolean_staged", spy)
    for delta_live in (False, True):
        if delta_live:
            ii.put([vocab[0], b"zz-new"], 777)
            assert eng.refresh(ii) is True and eng.delta is not None
        for op in ("and", "or"):
            for fr in (False, True):
                called.clear()
                got = eng.boolean(qs, op, filter_removed=fr)
                assert called == [1], "bulk Q must delegate to staged"
                for qi in range(len(qs)):
                    called.clear()
                    want = eng.boolean([qs[qi]], op, filter_removed=fr)[0]
                    assert not called  # below threshold: direct path
                    assert np.array_equal(got[qi], want), (
                        delta_live, op, fr, qi)


def test_lookup_staged_matches_lookup(tmp_path, rng):
    """lookup_staged (stream lookup through the concat classes) agrees with
    lookup() per term — misses surface as count-0 rows, prefix_p returns
    true counts + the first-P values."""
    ii, truth = build_index(tmp_path, rng)
    ii.put_removed(np.asarray([5], dtype=np.uint32))
    eng = QueryEngine.from_index(ii, L=128, q_bucket=8)
    vocab = sorted(truth.keys())
    batches = [vocab[:9] + [b"zz-missing"], vocab[9:20], []]
    for fr in (False, True):
        plain = [eng.lookup(b, filter_removed=fr) for b in batches]
        rows = eng.lookup_staged(batches, filter_removed=fr)
        pre = eng.lookup_staged(batches, filter_removed=fr,
                                columnar=True, prefix_p=4)
        for bi, terms in enumerate(batches):
            pv, pvo, pc = pre[bi]
            assert len(pvo) == len(terms) + 1
            for qi, t in enumerate(terms):
                want = plain[bi][qi]
                want = np.zeros(0, np.uint32) if want is None else want
                assert np.array_equal(rows[bi][qi], want), (fr, bi, qi)
                assert pc[qi] == len(want)
                assert np.array_equal(pv[pvo[qi]: pvo[qi + 1]], want[:4])


def _to_cols(qs):
    """list-of-term-lists -> (blob, offsets, qoffs) columnar triple."""
    flat = [t for q in qs for t in q]
    blob = b"".join(flat)
    offsets = np.zeros(len(flat) + 1, dtype=np.int64)
    np.cumsum([len(t) for t in flat], out=offsets[1:])
    qoffs = np.zeros(len(qs) + 1, dtype=np.int64)
    np.cumsum([len(q) for q in qs], out=qoffs[1:])
    return blob, offsets, qoffs


def test_boolean_staged_columnar_input(tmp_path, rng):
    """Columnar (blob, offsets, qoffs) batches serve identically to
    list-of-lists batches through every staged route (concat stream,
    prefix mode, and the per-batch fallback with a delta live)."""
    ii, truth = build_index(tmp_path, rng, n_docs=100)
    eng = QueryEngine.from_index(ii, L=128, q_bucket=8)
    vocab = sorted(truth.keys())
    rq = np.random.default_rng(9)
    batches = []
    for _ in range(2):
        qs = []
        for _ in range(6):
            k = int(rq.integers(1, 5))
            qs.append([vocab[i] for i in rq.choice(len(vocab), size=k, replace=False)])
        batches.append(qs)
    cols = [_to_cols(qs) for qs in batches]
    for op in ("or", "and"):
        a = eng.boolean_staged(batches, op, columnar=True)
        b = eng.boolean_staged(cols, op, columnar=True)
        for (va, oa), (vb, ob) in zip(a, b):
            assert np.array_equal(va, vb) and np.array_equal(oa, ob), op
        pa = eng.boolean_staged(batches, op, columnar=True, prefix_p=3)
        pb = eng.boolean_staged(cols, op, columnar=True, prefix_p=3)
        for ta, tb in zip(pa, pb):
            for xa, xb in zip(ta, tb):
                assert np.array_equal(xa, xb), op
    # delta live -> per-batch fallback must expand columnar batches
    ii.put([vocab[0], b"zz-new"], 999)
    assert eng.refresh(ii) is True and eng.delta is not None
    a = eng.boolean_staged(batches, "or", columnar=True)
    b = eng.boolean_staged(cols, "or", columnar=True)
    for (va, oa), (vb, ob) in zip(a, b):
        assert np.array_equal(va, vb) and np.array_equal(oa, ob)


def test_boolean_staged_dual_stream(tmp_path):
    """With a delta tier live, boolean_staged streams through the padded
    DUAL formulation — result-identical to boolean() per batch, ladder
    re-serves, tombstone filtering and prefix_p pagination included."""
    ii = InvertedIndex(str(tmp_path))
    for v in range(1, 300):  # long list -> ladder re-serve at L=128
        ii.put([b"aa-long", b"bb"], v)
    for v in range(1, 40):
        ii.put([b"cc", b"dd"] + [f"fill{v:02d}".encode()], v * 2)
    ii.put_removed(np.asarray([4, 10], dtype=np.uint32))
    eng = QueryEngine.from_index(ii, L=128, q_bucket=8)
    ii.put([b"aa-long", b"ee-new"], 999)
    ii.put([b"cc", b"ee-new"], 1000)
    assert eng.refresh(ii) is True and eng.delta is not None
    batches = [
        [[b"aa-long", b"bb"], [b"cc"], [b"aa-long", b"ee-new"]],
        [[b"cc", b"dd"], [b"ee-new"], [b"zz-missing", b"cc"]],
        [],
    ]
    for op in ("and", "or"):
        for fr in (False, True):
            staged = eng.boolean_staged(batches, op, filter_removed=fr)
            col = eng.boolean_staged(batches, op, filter_removed=fr,
                                     columnar=True)
            pre = eng.boolean_staged(batches, op, filter_removed=fr,
                                     columnar=True, prefix_p=3)
            for bi, qs in enumerate(batches):
                plain = eng.boolean(qs, op, filter_removed=fr)
                vals, voffs = col[bi]
                pv, pvo, pc = pre[bi]
                assert len(voffs) == len(qs) + 1
                for qi in range(len(qs)):
                    assert np.array_equal(staged[bi][qi], plain[qi]), \
                        (op, fr, bi, qi)
                    assert np.array_equal(
                        vals[voffs[qi]: voffs[qi + 1]], plain[qi])
                    assert pc[qi] == len(plain[qi])
                    assert np.array_equal(
                        pv[pvo[qi]: pvo[qi + 1]], plain[qi][:3])


# -- host-side full-result serving (retained tables) --------------------------


def _assert_rows_equal(a, b, ctx=""):
    assert len(a) == len(b), ctx
    for i, (x, y) in enumerate(zip(a, b)):
        if x is None or y is None:
            assert x is None and y is None, (ctx, i)
        else:
            assert np.array_equal(x, y), (ctx, i)


def test_lookup_host_matches_device(tmp_path, rng):
    """lookup_host (hash probe + native decode from retained tables, zero
    device round trips) is bit-identical to lookup() — plain, tombstone-
    filtered, misses, hostile terms."""
    ii, truth = build_index(tmp_path, rng)
    ii.put_removed(np.asarray([1, 7, 13], dtype=np.uint32))
    eng = QueryEngine.from_index(ii, L=128)  # keep_tables defaults True
    assert eng.host_ready()
    terms = sorted(truth.keys()) + [b"missing", b"\x00", b"zzzz" * 40]
    for fr in (False, True):
        _assert_rows_equal(
            eng.lookup_host(terms, filter_removed=fr),
            eng.lookup(terms, filter_removed=fr), f"fr={fr}",
        )


def test_lookup_host_requires_tables(tmp_path):
    ii = InvertedIndex(str(tmp_path))
    ii.put([b"a"], 1)
    eng = QueryEngine.from_index(ii, keep_tables=False)
    assert not eng.host_ready()
    with pytest.raises(RuntimeError):
        eng.lookup_host([b"a"])


def test_lookup_host_refresh_lifecycle(tmp_path, rng):
    """Retained tables track every refresh route: delta tier (union
    semantics + fresh tombstones), promotion, and full rebuild."""
    ii, truth = build_index(tmp_path, rng, n_docs=40)
    eng = QueryEngine.from_index(ii, L=128)
    # additive drift -> delta tier; host route must union both tiers
    ii.put([b"term000", b"brand-new"], 997)
    ii.put_removed([2])
    assert eng.refresh(ii) is True and eng.delta is not None
    assert eng.host_ready() and eng.delta_tables is not None
    terms = sorted(truth.keys()) + [b"brand-new", b"missing"]
    for fr in (False, True):
        _assert_rows_equal(
            eng.lookup_host(terms, filter_removed=fr),
            eng.lookup(terms, filter_removed=fr), f"delta fr={fr}",
        )
    # grow the delta past DELTA_FRACTION -> promotion folds tables too
    for d in range(60):
        ii.put([f"promo{d:03d}".encode()], 500 + d)
    assert eng.refresh(ii) is True
    assert eng.delta is None and eng.tables is not None
    _assert_rows_equal(
        eng.lookup_host(terms + [b"promo000"]),
        eng.lookup(terms + [b"promo000"]), "promoted",
    )
    # compaction (segments vanish) -> full rebuild route
    while ii.merge(2, 10_000, 2) > 0:
        pass
    assert eng.refresh(ii) is True
    _assert_rows_equal(eng.lookup_host(terms), eng.lookup(terms), "rebuilt")


def test_lookup_staged_host_route_matches_device(tmp_path, rng):
    """lookup_staged over retained tables (host route) returns exactly what
    the device concat-class stream returns, in all three output shapes."""
    ii, truth = build_index(tmp_path, rng)
    ii.put_removed(np.asarray([3, 9], dtype=np.uint32))
    host_eng = QueryEngine.from_index(ii, L=128)
    dev_eng = QueryEngine.from_index(ii, L=128, keep_tables=False)
    assert host_eng.host_ready() and not dev_eng.host_ready()
    keys = sorted(truth.keys())
    batches = [keys[:10] + [b"missing"], [], keys[10:25], [b"", b"zz"]]
    for fr in (False, True):
        h = host_eng.lookup_staged(batches, filter_removed=fr)
        d = dev_eng.lookup_staged(batches, filter_removed=fr)
        for bi in range(len(batches)):
            _assert_rows_equal(h[bi], d[bi], f"rows fr={fr} b={bi}")
        hc = host_eng.lookup_staged(batches, filter_removed=fr, columnar=True)
        dc = dev_eng.lookup_staged(batches, filter_removed=fr, columnar=True)
        for bi in range(len(batches)):
            assert np.array_equal(hc[bi][0], dc[bi][0]), (fr, bi)
            assert np.array_equal(hc[bi][1], dc[bi][1]), (fr, bi)
        hp = host_eng.lookup_staged(
            batches, filter_removed=fr, columnar=True, prefix_p=4)
        dp = dev_eng.lookup_staged(
            batches, filter_removed=fr, columnar=True, prefix_p=4)
        for bi in range(len(batches)):
            for part in range(3):
                assert np.array_equal(hp[bi][part], dp[bi][part]), (fr, bi)


def test_lookup_staged_host_route_with_delta(tmp_path, rng):
    ii, truth = build_index(tmp_path, rng, n_docs=30)
    eng = QueryEngine.from_index(ii, L=128)
    ii.put([b"term000", b"fresh"], 998)
    assert eng.refresh(ii) is True and eng.delta is not None
    keys = sorted(truth.keys())[:12] + [b"fresh", b"missing"]
    got = eng.lookup_staged([keys], columnar=True)[0]
    want = eng.lookup(keys)
    for qi, t in enumerate(keys):
        row = got[0][got[1][qi]: got[1][qi + 1]]
        exp = want[qi] if want[qi] is not None else np.zeros(0, np.uint32)
        assert np.array_equal(row, exp), t


def test_result_wire_codec_boundary_deltas(tmp_path):
    """Full-result fetches delta-pack on the wire (u8/u16 planes chosen per
    dispatch from the masked max delta, raw u32 fallback otherwise). Pin the
    boundary cases: deltas exactly 255/256/65535/65536, huge first values,
    single-value rows, and pad garbage past the row count."""
    ii = InvertedIndex(str(tmp_path))
    lists = {
        b"u8-edge": [10, 10 + 255, 10 + 255 + 255],
        b"u16-lo": [0, 256, 512],
        b"u16-edge": [7, 7 + 65535],
        b"u32-fb": [1, 1 + 65536, 2**32 - 2],
        b"huge-first": [2**32 - 3, 2**32 - 2],
        b"single": [42],
    }
    for t, vs in lists.items():
        for v in vs:
            ii.put([t], v)
    eng = QueryEngine.from_index(ii, L=128, q_bucket=8, keep_tables=False)
    terms = list(lists)
    # single-term ORs through the staged concat stream exercise every width
    got = eng.boolean_staged([[[t] for t in terms]], "or")[0]
    for qi, t in enumerate(terms):
        assert got[qi].tolist() == lists[t], t
    # the non-staged concat path shares the wire fetch
    got2 = eng.boolean([[t] for t in terms], "or")
    for qi, t in enumerate(terms):
        assert got2[qi].tolist() == lists[t], t
    # mixed-width dispatch in ONE class: same SB class, different deltas
    mix = eng.boolean([[b"u8-edge"], [b"u32-fb"], [b"u16-edge"]], "or")
    assert mix[0].tolist() == lists[b"u8-edge"]
    assert mix[1].tolist() == lists[b"u32-fb"]
    assert mix[2].tolist() == lists[b"u16-edge"]


def test_read_range_prefix_host_routes(tmp_path, rng):
    """read_range / prefix_search over retained tables (host route) match
    the device route bit-for-bit, including across a live delta tier."""
    ii, truth = build_index(tmp_path, rng, n_docs=35)
    host_eng = QueryEngine.from_index(ii, L=128)
    dev_eng = QueryEngine.from_index(ii, L=128, keep_tables=False)
    ii.put([b"term000", b"fresh-range"], 777)
    assert host_eng.refresh(ii) and dev_eng.refresh(ii)
    assert host_eng.delta is not None and host_eng.host_ready()
    for mn, mx in [(None, None), (b"term005", b"term030"), (b"z", None)]:
        a = list(host_eng.read_range(mn, mx))
        b = list(dev_eng.read_range(mn, mx))
        assert len(a) == len(b), (mn, mx)
        for (ta, va), (tb, vb) in zip(a, b):
            assert ta == tb and np.array_equal(va, vb), ta
    prefs = [b"term0", b"fresh", b"nope", b"", b"\xff"]
    pa = host_eng.prefix_search(prefs)
    pb = dev_eng.prefix_search(prefs)
    assert set(pa) == set(pb)
    for k in pa:
        assert np.array_equal(pa[k], pb[k]), k


def test_boolean_host_route_matches_device(tmp_path, rng, monkeypatch):
    """boolean_host (retained-tables serving) is bit-identical to the
    device paths for BOTH ops, across misses, a live delta tier, and
    tombstone filtering; boolean() routes OR host-side by default and
    TPI_HOST_BOOL overrides the policy."""
    ii, truth = build_index(tmp_path, rng, n_docs=80)
    big = b"big-list"
    for v in range(700):  # spans re-serve ladders on the device path
        ii.put([big], 5_000 + v)
    truth[big] = set(range(5_000, 5_700))
    host_eng = QueryEngine.from_index(ii, L=128, q_bucket=8)
    dev_eng = QueryEngine.from_index(ii, L=128, q_bucket=8, keep_tables=False)
    ii.put([b"term001", b"delta-only"], 9_999)
    truth.setdefault(b"term001", set()).add(9_999)
    truth[b"delta-only"] = {9_999}
    assert host_eng.refresh(ii) and dev_eng.refresh(ii)
    assert host_eng.host_ready() and host_eng.delta is not None
    queries = [
        [b"term001", b"term002"],
        [big, b"term003"],
        [b"missing", b"term004"],
        [b"delta-only"],
        [b"term005"],
        [big],
        [b"", b"a"],
    ]
    for op in ("and", "or"):
        hh = host_eng.boolean_host(queries, op)
        monkeypatch.setenv("TPI_HOST_BOOL", "0")
        dd = dev_eng.boolean(queries, op)
        monkeypatch.delenv("TPI_HOST_BOOL")
        for q, a, b in zip(queries, hh, dd):
            assert a.dtype == np.uint32 and np.array_equal(a, b), (op, q)
    # routing policy: auto = full-result OR host-side iff the measured
    # device link is slow (TPI_LINK_MBPS pins the probe); knob overrides
    calls = []
    orig = QueryEngine.boolean_host
    monkeypatch.setattr(
        QueryEngine, "boolean_host",
        lambda self, *a, **k: calls.append(a[1]) or orig(self, *a, **k),
    )
    monkeypatch.setattr(qe_mod, "_LINK_MBPS", None)
    monkeypatch.setenv("TPI_LINK_MBPS", "33")  # slow link: host routes
    host_eng.boolean([[b"term001"]], "or")
    host_eng.boolean([[b"term001", b"term002"]], "and")  # non-staged: host
    assert calls == ["or", "and"]
    # staged routes host-side too on a slow link
    assert host_eng._host_boolean_route("and", staged=True)
    assert host_eng._host_boolean_route("or", staged=True)
    monkeypatch.setattr(qe_mod, "_LINK_MBPS", None)
    monkeypatch.setenv("TPI_LINK_MBPS", "10000")  # PCIe-like: device route
    host_eng.boolean([[b"term001"]], "or")
    host_eng.boolean([[b"term001", b"term002"]], "and")
    assert calls == ["or", "and"]
    monkeypatch.setenv("TPI_HOST_BOOL", "all")
    host_eng.boolean([[b"term001", b"term002"]], "and")
    assert calls == ["or", "and", "and"]
    monkeypatch.setenv("TPI_HOST_BOOL", "0")
    host_eng.boolean([[b"term001"]], "or")
    assert calls == ["or", "and", "and"]


def test_boolean_host_tombstones_and_staged(tmp_path, rng, monkeypatch):
    """Host-route tombstone filtering matches the device filter; the staged
    stream's host route returns the same shapes as the device stream."""
    monkeypatch.setattr(qe_mod, "_LINK_MBPS", None)
    monkeypatch.setenv("TPI_LINK_MBPS", "33")  # slow link: OR routes host
    ii, truth = build_index(tmp_path, rng, n_docs=60)
    removed = [2, 5, 9]
    ii.put_removed(removed)
    host_eng = QueryEngine.from_index(ii, L=128, q_bucket=8, apply_removed=True)
    dev_eng = QueryEngine.from_index(
        ii, L=128, q_bucket=8, apply_removed=True, keep_tables=False
    )
    queries = [[b"term001", b"term002"], [b"term003"], [b"missing"]]
    for op in ("and", "or"):
        a = host_eng.boolean_host(queries, op, filter_removed=True)
        b = dev_eng.boolean(queries, op, filter_removed=True)
        for q, x, y in zip(queries, a, b):
            assert np.array_equal(x, y), (op, q)
            assert not set(x.tolist()) & set(removed)
    # staged host route: per-batch results and columnar form both match
    stream = [queries, queries[:2]]
    sh = host_eng.boolean_staged(stream, "or")
    sd = dev_eng.boolean_staged(stream, "or")
    assert len(sh) == len(sd)
    for bh, bd in zip(sh, sd):
        for x, y in zip(bh, bd):
            assert np.array_equal(x, y)
    ch = host_eng.boolean_staged(stream, "or", columnar=True)
    for (vals, voffs), bd in zip(ch, sd):
        assert voffs[0] == 0 and voffs[-1] == len(vals)
        for i, y in enumerate(bd):
            assert np.array_equal(vals[voffs[i] : voffs[i + 1]], y)


def test_boolean_host_native_matches_numpy_oracle(tmp_path, rng, monkeypatch):
    """The fused native serve (tpi_boolean_serve: decode + set op straight
    from the compressed streams, block-skip AND walk) is bit-identical to
    the pure-numpy fallback across misses, a live delta tier, tombstones,
    empty queries, and >L lists."""
    from inverted_index_2_tpu.codec import native

    if not native.available():
        pytest.skip("native codec not built")
    ii, truth = build_index(tmp_path, rng, n_docs=70)
    for v in range(600):
        ii.put([b"long-list"], 4_000 + v)
    ii.put_removed([4_001, 4_500, 2])
    eng = QueryEngine.from_index(ii, L=128, q_bucket=8, apply_removed=True)
    ii.put([b"term002", b"only-delta"], 8_888)  # live delta tier
    assert eng.refresh(ii)
    queries = [
        [b"term001", b"term002"],
        [b"long-list", b"term003"],
        [b"long-list"],
        [b"only-delta", b"term002"],
        [b"missing", b"term004"],
        [],
        [b"term005", b"term006", b"term007", b"term001"],
    ]
    for op in ("and", "or"):
        for fr in (False, True):
            nat = eng._boolean_host_columnar(queries, op, fr)
            monkeypatch.setattr(qe_mod._native, "available", lambda: False)
            ref = eng._boolean_host_columnar(queries, op, fr)
            monkeypatch.undo()
            assert np.array_equal(nat[0], ref[0]), (op, fr)
            assert np.array_equal(nat[1], ref[1]), (op, fr)


def test_host_busy_load_aware_fallback(tmp_path, rng, monkeypatch):
    """Load-aware routing: with the host cores saturated
    (loadavg/core above TPI_HOST_BUSY_LOAD), the staged AND stream falls
    back to the device pipeline — the host route's zero-link-byte edge
    assumed a free CPU. One-shot AND and OR stay host-routed (the device
    alternatives there are dispatch-latency / fetch-volume bound and lose
    even to a contended host)."""
    import os as os_mod

    monkeypatch.setattr(qe_mod, "_LINK_MBPS", None)
    monkeypatch.setenv("TPI_LINK_MBPS", "33")  # slow link: host-route regime
    ii, _ = build_index(tmp_path, rng, n_docs=30)
    eng = QueryEngine.from_index(ii, L=128, q_bucket=8)
    monkeypatch.setenv("TPI_HOST_BUSY_LOAD", "1.5")
    monkeypatch.setattr(os_mod, "getloadavg",
                        lambda: (99.0 * (os_mod.cpu_count() or 1), 0.0, 0.0))
    assert not eng._host_boolean_route("and", staged=True)  # busy -> device
    assert eng._host_boolean_route("and", staged=False)     # one-shot: host
    # staged OR under load: best-available is the staged device concat
    # stream; one-shot OR stays host (device one-shot OR
    # is fetch-volume bound, below even a contended host)
    assert not eng._host_boolean_route("or", staged=True)
    assert eng._host_boolean_route("or", staged=False)
    monkeypatch.setattr(os_mod, "getloadavg", lambda: (0.1, 0.0, 0.0))
    assert eng._host_boolean_route("and", staged=True)      # idle -> host
    monkeypatch.setenv("TPI_HOST_BUSY_LOAD", "0")           # fallback off
    monkeypatch.setattr(os_mod, "getloadavg",
                        lambda: (99.0 * (os_mod.cpu_count() or 1), 0.0, 0.0))
    assert eng._host_boolean_route("and", staged=True)
    # the busy fallback serves bit-identically through the device pipeline
    monkeypatch.setenv("TPI_HOST_BUSY_LOAD", "1.5")
    qs = [[b"term001", b"term002"], [b"term003"]]
    dev = eng.boolean_staged([qs], "and")
    monkeypatch.setenv("TPI_HOST_BUSY_LOAD", "0")
    host = eng.boolean_staged([qs], "and")
    for a, b in zip(dev[0], host[0]):
        assert np.array_equal(a, b)


def test_host_busy_engine_internal_signal(tmp_path, rng, monkeypatch):
    """The router's PRIMARY busy signal is the engine's own index:
    is_busy() is True exactly while a put/put_removed/merge call
    is in flight, so the route flips within ONE batch of a merge starting
    or stopping — no 1-minute loadavg lag in either direction. The storm
    below drives a live merge loop while asserting the route choice on
    both edges."""
    import os as os_mod
    import threading

    monkeypatch.setattr(qe_mod, "_LINK_MBPS", None)
    monkeypatch.setenv("TPI_LINK_MBPS", "33")  # slow link: host-route regime
    monkeypatch.setenv("TPI_HOST_BUSY_LOAD", "1.5")
    # loadavg pinned IDLE throughout: every flip below is the engine's own
    # signal, not the fallback
    monkeypatch.setattr(os_mod, "getloadavg", lambda: (0.0, 0.0, 0.0))
    ii, _ = build_index(tmp_path, rng, n_docs=30)
    eng = QueryEngine.from_index(ii, L=128, q_bucket=8)
    assert eng._busy_fn is not None
    assert eng._host_boolean_route("and", staged=True)   # idle -> host
    assert eng._host_boolean_route("or", staged=True)

    # hold a merge mid-flight: the route must flip immediately
    gate = threading.Event()
    entered = threading.Event()
    from inverted_index_2_tpu.shard import Shard
    orig_merge = Shard.merge

    def slow_merge(self, req, m):
        entered.set()
        gate.wait(timeout=30)
        return orig_merge(self, req, m)

    monkeypatch.setattr(Shard, "merge", slow_merge)
    th = threading.Thread(target=lambda: ii.merge(2, 100, 1))
    th.start()
    assert entered.wait(timeout=30)
    assert ii.is_busy()
    assert not eng._host_boolean_route("and", staged=True)  # busy -> device
    assert not eng._host_boolean_route("or", staged=True)
    assert eng._host_boolean_route("and", staged=False)     # one-shot: host
    gate.set()
    th.join(timeout=60)
    assert not ii.is_busy()
    assert eng._host_boolean_route("and", staged=True)   # merge done -> host
    assert eng._host_boolean_route("or", staged=True)
    # storm: unsynchronized route reads while a put/merge loop runs —
    # route choice must track the busy edges without poisoning
    monkeypatch.setattr(Shard, "merge", orig_merge)
    stop = threading.Event()
    seen_busy = []

    def writer():
        d = 1000
        while not stop.is_set():
            ii.put([f"w{d}".encode()], d)
            ii.merge(2, 100, 1)
            d += 1

    wt = threading.Thread(target=writer)
    wt.start()
    for _ in range(300):
        seen_busy.append(not eng._host_boolean_route("and", staged=True))
    stop.set()
    wt.join(timeout=60)
    assert any(seen_busy)  # the storm was observed busy at least once
    assert eng._host_boolean_route("and", staged=True)  # and clears after


def test_or_wire_dedup_device_route(tmp_path, rng, monkeypatch):
    """Full-result OR on the device concat route ships the sorted stream
    WITH cross-list duplicates (wire_dedup) and the host drops the zero
    deltas — results must be bit-identical to the host oracle across
    duplicate terms ([t, t] duplicates EVERY value), heavy overlap,
    misses, and both wire settings (packed deltas and raw trim)."""
    ii, truth = build_index(tmp_path, rng, n_docs=80)
    # heavy-overlap pair: two terms sharing most postings
    for d in range(200, 260):
        ii.put([b"ov-a", b"ov-b"] if d % 3 else [b"ov-a"], d)
    truth[b"ov-a"] = {d for d in range(200, 260)}
    truth[b"ov-b"] = {d for d in range(200, 260) if d % 3}
    eng = QueryEngine.from_index(ii, L=128, q_bucket=8, keep_tables=False)
    vocab = sorted(truth.keys())
    queries = [
        [b"ov-a", b"ov-b"],
        [b"ov-a", b"ov-a"],          # duplicate term: every value repeats
        [vocab[0], vocab[1], vocab[2]],
        [b"missing", b"ov-b"],
        [b"ov-a"],
        [vocab[3], vocab[3], vocab[3]],
    ]
    want = []
    for q in queries:
        u = set()
        for t in q:
            u |= truth.get(t, set())
        want.append(sorted(u))
    monkeypatch.setenv("TPI_HOST_BOOL", "0")  # pin the device concat route
    for wire in ("1", "0"):
        monkeypatch.setenv("TPI_WIRE", wire)
        got = eng.boolean(queries, "or")
        for g, w in zip(got, want):
            assert g.tolist() == w, wire
        got_s = eng.boolean_staged([queries], "or")[0]
        for g, w in zip(got_s, want):
            assert g.tolist() == w, wire
        vals, voffs = eng.boolean_staged([queries], "or", columnar=True)[0]
        for i, w in enumerate(want):
            assert vals[voffs[i]:voffs[i + 1]].tolist() == w, wire


def test_or_pagination_u16_overflow_escape(tmp_path, rng, monkeypatch):
    """Pagination pages whose deltas exceed 2^16 must come back exact via
    the overflow-row escape (steps._pack_p_step's flag bit + raw re-fetch):
    doc ids spaced ~70k apart overflow every u16 delta, mixed with dense
    small-gap terms so packed and escaped rows coexist in one batch."""
    ii = InvertedIndex(str(tmp_path))
    truth = {}
    wide = [1 + 70_001 * i for i in range(40)]        # every gap > 2^16
    for d in wide:
        ii.put([b"wide", b"wide2"] if d % 3 else [b"wide"], d)
    truth[b"wide"] = set(wide)
    truth[b"wide2"] = {d for d in wide if d % 3}
    for d in range(500, 560):                          # dense, tiny gaps
        ii.put([b"dense-a", b"dense-b"], d)
    truth[b"dense-a"] = truth[b"dense-b"] = set(range(500, 560))
    eng = QueryEngine.from_index(ii, L=128, q_bucket=8, keep_tables=False)
    queries = [
        [b"wide", b"wide2"],       # overflow row
        [b"dense-a", b"dense-b"],  # packed row
        [b"wide", b"dense-a"],     # mixed gaps: overflow row
        [b"missing", b"wide2"],
        [b"dense-a"],
    ]
    want = [sorted(set().union(*[truth.get(t, set()) for t in q]))
            for q in queries]
    monkeypatch.setenv("TPI_HOST_BOOL", "0")  # pin the device route
    for wire in ("1", "0"):
        monkeypatch.setenv("TPI_WIRE", wire)
        for P in (4, 16, 64):
            vals, voffs, counts = eng.boolean_staged(
                [queries], "or", columnar=True, prefix_p=P)[0]
            for i, w in enumerate(want):
                assert counts[i] == len(w), (wire, P, i)
                assert vals[voffs[i]:voffs[i + 1]].tolist() == w[:P], (
                    wire, P, i)


def test_host_resolve_device_serve_matches_oracle(tmp_path, rng, monkeypatch):
    """Engines with retained tables resolve the dictionary ON HOST for the
    device concat stream and the one-shot concat path (steps.
    _host_resolve_sb) — idx/found ship instead of packed qkeys and no
    blocking fetch gates dispatch. Results must stay bit-identical to the
    device-resolve engine across found/missing mixes, both ops, pagination
    and full-result forms."""
    ii = InvertedIndex(str(tmp_path))
    truth = {}
    terms = [b"t%03d" % i for i in range(60)]
    for d in range(1, 400):
        tl = [terms[int(x)] for x in rng.choice(60, size=1 + d % 5,
                                                replace=False)]
        for t in tl:
            truth.setdefault(t, set()).add(d)
        ii.put(tl, d)
    eng_t = QueryEngine.from_index(ii, L=128, q_bucket=8)   # tables kept
    eng_d = QueryEngine.from_index(ii, L=128, q_bucket=8,
                                   keep_tables=False)       # device resolve
    assert eng_t.host_ready() and not eng_d.host_ready()
    queries = [
        [terms[0], b"missing", terms[7]],
        [terms[3]],
        [b"missing-a", b"missing-b"],
        [terms[11], terms[13], terms[17], terms[19]],
    ] + [[terms[int(a)], terms[int(b)]]
         for a, b in rng.integers(0, 60, size=(17, 2))]
    monkeypatch.setenv("TPI_HOST_BOOL", "0")  # pin the device pipeline
    for op in ("or", "and"):
        want = eng_d.boolean(queries, op)
        got = eng_t.boolean(queries, op)
        for i, (w, g) in enumerate(zip(want, got)):
            assert np.array_equal(w, g), (op, i)
        for P in (0, 8):
            kw = dict(columnar=True, prefix_p=P) if P else dict(
                columnar=True)
            a = eng_d.boolean_staged([queries], op, **kw)[0]
            b = eng_t.boolean_staged([queries], op, **kw)[0]
            for x, y in zip(a, b):
                assert np.array_equal(x, y), (op, P)


def test_or_pagination_with_tombstones_device_route(tmp_path, rng,
                                                    monkeypatch):
    """prefix_p + filter_removed on the DEVICE route: the windowed
    compaction is only valid unfiltered, so this path runs the full
    compaction, then _JIT_FILTER, then the scatter/pack harvest — counts
    must be post-filter exact and pages must skip purged values."""
    ii = InvertedIndex(str(tmp_path))
    truth = {}
    terms = [b"q%02d" % i for i in range(20)]
    for d in range(1, 300):
        tl = [terms[int(x)] for x in rng.choice(20, size=2 + d % 3,
                                                replace=False)]
        for t in tl:
            truth.setdefault(t, set()).add(d)
        ii.put(tl, d)
    dead = {7, 8, 50, 123, 250, 299}
    ii.put_removed(np.asarray(sorted(dead), dtype=np.uint32))
    for t in truth:
        truth[t] -= dead
    # tombstones live in the removed list (reads never apply them until
    # merge) — the engine filter is what this test exercises
    eng = QueryEngine.from_index(ii, L=128, q_bucket=8, keep_tables=False)
    queries = [[terms[i], terms[(i * 3 + 1) % 20]] for i in range(16)]
    want = [sorted(truth[a] | truth[b]) for a, b in queries]
    monkeypatch.setenv("TPI_HOST_BOOL", "0")
    for wire in ("1", "0"):
        monkeypatch.setenv("TPI_WIRE", wire)
        for P in (4, 32):
            vals, voffs, counts = eng.boolean_staged(
                [queries], "or", filter_removed=True, columnar=True,
                prefix_p=P)[0]
            for i, w in enumerate(want):
                assert counts[i] == len(w), (wire, P, i)
                assert vals[voffs[i]:voffs[i + 1]].tolist() == w[:P], (
                    wire, P, i)


def test_staged_dedup_zipf_mix_bit_identical(tmp_path, rng, monkeypatch):
    """Cross-query dedup in the staged AND stream: a Zipf-style mix
    repeating whole queries serves each distinct term-set ONCE and fans
    results out at assembly — bit-identical to the dedup-disabled stream
    in every output form (columnar, rows, filter_removed), including wide
    results duplicated across the batch."""
    ii = InvertedIndex(str(tmp_path))
    truth = {}
    # hot pair with a WIDE intersection (40 docs): its duplicates fan out
    # a multi-value row
    for d in range(1, 41):
        ii.put([b"hot1", b"hot2"], d)
        truth.setdefault(b"hot1", set()).add(d)
        truth.setdefault(b"hot2", set()).add(d)
    for i in range(30):
        t = b"cold%02d" % i
        for d in range(100 + i * 3, 103 + i * 3):
            ii.put([t], d)
            truth.setdefault(t, set()).add(d)
    ii.put_removed([2, 101])
    eng = QueryEngine.from_index(ii, L=128, q_bucket=64, keep_tables=False)
    monkeypatch.setenv("TPI_HOST_BOOL", "0")      # pin the device route
    # "force" skips the BENEFIT gate (test batches are far too small to
    # clear the ~ms-scale crossover) but never the shrink check
    monkeypatch.setenv("TPI_STAGED_DEDUP", "force")
    rng2 = np.random.default_rng(11)
    batches = []
    for _ in range(3):
        qs = []
        for _ in range(96):
            r = rng2.random()
            if r < 0.55:                       # Zipf head: one hot query
                qs.append([b"hot1", b"hot2"])
            elif r < 0.8:
                i = int(rng2.integers(0, 30))
                qs.append([b"cold%02d" % i, b"hot1"])
            else:                              # tail: mostly-unique pairs
                i, j = rng2.choice(30, size=2, replace=False)
                qs.append([b"cold%02d" % int(i), b"cold%02d" % int(j)])
        batches.append(qs)

    # rows the device resolve pass serves per batch (no retained tables:
    # the concat stream resolves every batch on device)
    served_rows = []
    orig_run = staged_mod._JIT_RESOLVE_SB

    def spy_run(keys, counts, qk, *a, **k):
        served_rows.append(qk.shape[0])
        return orig_run(keys, counts, qk, *a, **k)

    monkeypatch.setattr(staged_mod, "_JIT_RESOLVE_SB", spy_run)
    for fr in (False, True):
        ded_cols = eng.boolean_staged(batches, "and", columnar=True,
                                      filter_removed=fr)
        ded_rows = eng.boolean_staged(batches, "and", filter_removed=fr)
        monkeypatch.setenv("TPI_STAGED_DEDUP", "0")
        ref_cols = eng.boolean_staged(batches, "and", columnar=True,
                                      filter_removed=fr)
        ref_rows = eng.boolean_staged(batches, "and", filter_removed=fr)
        monkeypatch.setenv("TPI_STAGED_DEDUP", "force")
        for (va, oa), (vb, ob) in zip(ded_cols, ref_cols):
            assert np.array_equal(va, vb) and np.array_equal(oa, ob)
        for ba, bb in zip(ded_rows, ref_rows):
            assert len(ba) == len(bb)
            for x, y in zip(ba, bb):
                assert np.array_equal(x, y)
        # oracle: every duplicate of the hot query answers the true
        # intersection minus nothing (reads never apply tombstones) or
        # minus the removed docs under filter_removed
        want = sorted(truth[b"hot1"] & truth[b"hot2"] - ({2} if fr else set()))
        for qs, rows in zip(batches, ded_rows):
            for q, r in zip(qs, rows):
                if q == [b"hot1", b"hot2"]:
                    assert r.tolist() == want
    # the dedup stream dispatched FEWER rows than the baseline: per fr the
    # call order is ded_cols, ded_rows, ref_cols, ref_rows (3 batches
    # each) — dedup rows pad to the q_bucket/16 grid, baseline to q_bucket
    n = len(batches)
    assert len(served_rows) == 8 * n
    for base in (0, 4 * n):
        ded = sum(served_rows[base: base + 2 * n])
        ref = sum(served_rows[base + 2 * n: base + 4 * n])
        assert ded < ref, served_rows


def test_host_dedup_zipf_mix_bit_identical(tmp_path, monkeypatch):
    """Cross-query dedup on the HOST serving route (r5, extending the
    staged-stream lever to the route that serves full-result OR): a
    Zipf-style batch repeating whole queries serves each distinct
    term-sequence ONCE through the packed serve core and fans the columnar
    results back out — bit-identical to the dedup-disabled serve for both
    ops, both native and numpy-oracle paths, with a delta tier live,
    tombstones under filter_removed, misses, and ragged k (1..4 incl. an
    empty query). Covers boolean_host rows, the columnar core, wire-form
    columnar input, and the staged host route."""
    ii = InvertedIndex(str(tmp_path))
    rng2 = np.random.default_rng(7)
    for i in range(40):
        t = b"t%02d" % i
        for d in np.unique(rng2.integers(1, 400, size=30)):
            ii.put([t], int(d))
    ii.put_removed([5, 17, 200])
    eng = QueryEngine.from_index(ii, L=64, q_bucket=64, keep_tables=True)
    for d in range(500, 520):  # additive window -> delta tier live
        ii.put([b"t01", b"delta0"], d)
    assert eng.refresh(ii) is True
    assert eng.delta is not None
    # distinct-query pool: ragged k, misses, an empty query, delta term
    pool = [[b"t%02d" % int(i) for i in rng2.choice(40, size=k, replace=False)]
            for k in (1, 2, 2, 3, 3, 4) for _ in range(4)]
    pool += [[b"nope"], [b"t05", b"nope"], [], [b"delta0", b"t01"]]
    zw = 1.0 / np.arange(1, len(pool) + 1)
    zw /= zw.sum()
    batch = [pool[i] for i in rng2.choice(len(pool), size=300, p=zw)]
    # wire-form twin of the same batch
    blob = b"".join(t for q in batch for t in q)
    toffs = np.zeros(sum(len(q) for q in batch) + 1, np.int64)
    np.cumsum([len(t) for q in batch for t in q], out=toffs[1:])
    qoffs = np.zeros(len(batch) + 1, np.int64)
    np.cumsum([len(q) for q in batch], out=qoffs[1:])
    wire = (blob, toffs, qoffs)

    served_nq = []
    orig_core = QueryEngine._host_serve_columnar

    def spy_core(self, qk, koffs, op, filter_removed, st):
        served_nq.append(len(koffs) - 1)
        return orig_core(self, qk, koffs, op, filter_removed, st)

    monkeypatch.setattr(QueryEngine, "_host_serve_columnar", spy_core)
    n_unique = len({tuple(q) for q in batch})
    real_avail = qe_mod._native.available
    for native_on in (real_avail(), False):
        monkeypatch.setattr(qe_mod._native, "available",
                            (lambda: True) if native_on else (lambda: False))
        for op in ("or", "and"):
            for fr in (False, True):
                monkeypatch.setenv("TPI_HOST_DEDUP", "force")
                ded_rows = eng.boolean_host(batch, op, filter_removed=fr)
                ded_cols = eng._boolean_host_columnar(wire, op, fr)
                assert served_nq[-2:] == [n_unique, n_unique]
                monkeypatch.setenv("TPI_HOST_DEDUP", "0")
                ref_rows = eng.boolean_host(batch, op, filter_removed=fr)
                ref_cols = eng._boolean_host_columnar(wire, op, fr)
                assert served_nq[-2:] == [len(batch), len(batch)]
                for x, y in zip(ded_rows, ref_rows):
                    assert np.array_equal(x, y)
                assert np.array_equal(ded_cols[0], ref_cols[0])
                assert np.array_equal(ded_cols[1], ref_cols[1])
    # staged host route (the production entry for full-result OR): pinned
    # host via TPI_HOST_BOOL=all, dedup on vs off, columnar contract
    monkeypatch.setattr(qe_mod._native, "available", real_avail)
    monkeypatch.setenv("TPI_HOST_BOOL", "all")
    monkeypatch.setenv("TPI_HOST_DEDUP", "force")
    a = eng.boolean_staged([batch, batch[::-1]], "or", columnar=True)
    monkeypatch.setenv("TPI_HOST_DEDUP", "0")
    b = eng.boolean_staged([batch, batch[::-1]], "or", columnar=True)
    for (va, oa), (vb, ob) in zip(a, b):
        assert np.array_equal(va, vb) and np.array_equal(oa, ob)


def test_host_dedup_gate_and_shrink_check(tmp_path, monkeypatch):
    """The host dedup engages only when it can pay: small batches (<256)
    and all-unique batches serve straight through even under force; the
    auto gate rejects savings below the grouping-cost crossover."""
    ii = InvertedIndex(str(tmp_path))
    for i in range(20):
        for d in range(1, 6):
            ii.put([b"g%02d" % i], d)
    eng = QueryEngine.from_index(ii, L=64, q_bucket=64, keep_tables=True)
    st = eng._state
    import inverted_index_2_tpu.codec.keys as keys_mod

    def packed(batch):
        qk = keys_mod.pack_terms([t for q in batch for t in q],
                                 width=st.host_q_width())
        koffs = np.zeros(len(batch) + 1, np.int64)
        np.cumsum([len(q) for q in batch], out=koffs[1:])
        return qk, koffs
    monkeypatch.setenv("TPI_HOST_DEDUP", "force")
    small = [[b"g00"], [b"g00"]] * 64  # 128 rows < 256
    assert eng._host_dedup_group(*packed(small), "or") is None
    uniq = [[b"g%02d" % (i % 20), b"g%02d" % ((i // 20) % 20)]
            for i in range(400)]
    assert eng._host_dedup_group(*packed(uniq), "or") is None  # no shrink
    dup = [[b"g00", b"g01"]] * 400
    got = eng._host_dedup_group(*packed(dup), "or")
    assert got is not None
    qk_u, koffs_u, gid = got
    assert len(koffs_u) - 1 == 1 and np.all(gid == 0)
    # auto mode: 400 dup queries save ~4.8 ms of OR serve -> engages;
    # the same batch as AND (~3 us/query) does not clear the ~4 ms bar
    monkeypatch.setenv("TPI_HOST_DEDUP", "1")
    assert eng._host_dedup_group(*packed(dup), "or") is not None
    assert eng._host_dedup_group(*packed(dup), "and") is None


def test_concat_stream_dedup_zipf_bit_identical(tmp_path, monkeypatch):
    """Cross-query dedup in the staged CONCAT stream — the device route
    serving OR (full + prefix_p pagination) and staged AND:
    a Zipf mix serves unique rows once and fans out at harvest, cutting
    compute AND wire volume by the duplicate factor. Bit-identical to the
    dedup-disabled stream in every output form, tombstones included
    (full-result OR with removed=None also exercises the wire-dedup
    fan-out; prefix_p exercises the row-gather)."""
    ii = InvertedIndex(str(tmp_path))
    truth = {}
    rng2 = np.random.default_rng(23)
    for i in range(24):
        t = b"w%02d" % i
        for d in np.unique(rng2.integers(1, 300, size=40)):
            ii.put([t], int(d))
            truth.setdefault(t, set()).add(int(d))
    ii.put_removed([7, 30])
    eng = QueryEngine.from_index(ii, L=64, q_bucket=64, keep_tables=True)
    monkeypatch.setenv("TPI_HOST_BOOL", "0")       # pin the device route
    monkeypatch.setenv("TPI_STAGED_DEDUP", "force")
    pool = [[b"w%02d" % int(i) for i in rng2.choice(24, size=k,
                                                    replace=False)]
            for k in (1, 2, 2, 3, 4) for _ in range(4)]
    zw = 1.0 / np.arange(1, len(pool) + 1)
    zw /= zw.sum()
    batches = [[pool[i] for i in rng2.choice(len(pool), size=96, p=zw)]
               for _ in range(3)]

    served_nq = []
    orig = QueryEngine._dedup_batch

    def spy(self, nq, qk, kv):
        r = orig(self, nq, qk, kv)
        served_nq.append((nq, r[0], r[3] is not None))
        return r

    monkeypatch.setattr(QueryEngine, "_dedup_batch", spy)
    for kwargs in (dict(columnar=True), dict(),
                   dict(columnar=True, prefix_p=8),
                   dict(columnar=True, filter_removed=True),
                   dict(columnar=True, prefix_p=8, filter_removed=True)):
        ded = eng.boolean_staged(batches, "or", depth=2, **kwargs)
        assert served_nq and all(e[2] and e[1] < e[0]
                                 for e in served_nq[-3:])
        monkeypatch.setenv("TPI_STAGED_DEDUP", "0")
        ref = eng.boolean_staged(batches, "or", depth=2, **kwargs)
        monkeypatch.setenv("TPI_STAGED_DEDUP", "force")
        for a, b in zip(ded, ref):
            if isinstance(a, tuple):
                for x, y in zip(a, b):
                    assert np.array_equal(x, y)
            else:
                for x, y in zip(a, b):
                    assert np.array_equal(x, y)
    # oracle vs ground truth on one columnar batch (dedup on): full OR
    vals, voffs = eng.boolean_staged(batches[:1], "or", columnar=True,
                                     depth=2)[0]
    for q, want_terms in enumerate(batches[0]):
        want = sorted(set().union(*(truth[t] for t in want_terms)))
        assert vals[voffs[q]: voffs[q + 1]].tolist() == want
