"""Sharded (multi-device) query fan-out on the 8-virtual-CPU-device mesh —
the analogue of BASELINE config 4/5 (64 shards hash-routed, fan-out query
with result merge over collectives)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from inverted_index_2_tpu import InvertedIndex
from inverted_index_2_tpu.codec import keys as K
from inverted_index_2_tpu.parallel import mesh as pm


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return pm.default_mesh(8)


@pytest.fixture(scope="module")
def built(tmp_path_factory, mesh8):
    rng = np.random.default_rng(7)
    tmp = tmp_path_factory.mktemp("idx")
    ii = InvertedIndex(str(tmp))
    # spread terms across many shards (vary the 2-byte prefix)
    vocab = [bytes([a, b]) + f"t{i}".encode() for i, (a, b) in enumerate(
        (int(x), int(y)) for x, y in rng.integers(32, 127, size=(120, 2))
    )]
    truth = {}
    for doc in range(1, 50):
        k = int(rng.integers(1, 6))
        terms = [vocab[i] for i in rng.choice(len(vocab), size=k, replace=False)]
        ii.put(terms, doc)
        for t in terms:
            truth.setdefault(t, set()).add(doc)
    snap = pm.build_sharded_snapshot(ii, mesh8)
    return ii, truth, snap


def test_sharded_lookup_exact(built, mesh8):
    ii, truth, snap = built
    L = 128
    lookup = pm.make_sharded_lookup(snap, L)
    terms = sorted(truth.keys())[:40] + [b"@@missing", b"zz-none"]
    qk = K.pack_terms(terms, width=snap.width)
    import jax.numpy as jnp2

    found, vals, n, raw = lookup(
        snap.keys, snap.blocks, snap.term_block_start, snap.counts,
        jnp2.asarray(qk),
    )
    found, vals, n, raw = (
        np.asarray(found), np.asarray(vals), np.asarray(n), np.asarray(raw)
    )
    for i, t in enumerate(terms):
        if t in truth:
            assert found[i], t
            assert raw[i] == len(truth[t]), t  # true count survives the psum
            assert vals[i, : n[i]].tolist() == sorted(truth[t]), t
        else:
            assert not found[i], t
            assert raw[i] == 0


def test_sharded_boolean_and(built, mesh8):
    ii, truth, snap = built
    import jax.numpy as jnp2

    L = 128
    booland = pm.make_sharded_boolean(snap, L, "and")
    vocab = sorted(truth.keys())
    rng = np.random.default_rng(3)
    queries = [
        [vocab[i] for i in rng.choice(len(vocab), size=3, replace=False)]
        for _ in range(12)
    ]
    Kk = 3
    qk = np.zeros((len(queries), Kk, snap.width + 1), dtype=np.uint32)
    kv = np.full(len(queries), Kk, dtype=np.int32)
    for i, q in enumerate(queries):
        qk[i] = K.pack_terms(q, width=snap.width)
    out, oc, need = booland(
        snap.keys, snap.blocks, snap.term_block_start, snap.counts,
        jnp2.asarray(qk), jnp2.asarray(kv),
    )
    out, oc, need = np.asarray(out), np.asarray(oc), np.asarray(need)
    for i, q in enumerate(queries):
        want = sorted(set.intersection(*[truth[t] for t in q]))
        assert need[i] == max(len(truth[t]) for t in q), q  # trunc signal
        assert out[i, : oc[i]].tolist() == want, q


def test_shard_ranges_cover_keyspace():
    for d in (1, 2, 8, 64):
        rs = pm.shard_ranges(d)
        seen = sorted(x for r in rs for x in r)
        assert seen == list(range(1024))


def test_sharded_boolean_or(built, mesh8):
    ii, truth, snap = built
    import jax.numpy as jnp2

    L = 128
    boolor = pm.make_sharded_boolean(snap, L, "or")
    vocab = sorted(truth.keys())
    rng = np.random.default_rng(9)
    queries = [
        [vocab[i] for i in rng.choice(len(vocab), size=2, replace=False)]
        for _ in range(8)
    ]
    qk = np.zeros((len(queries), 2, snap.width + 1), dtype=np.uint32)
    for i, q in enumerate(queries):
        qk[i] = K.pack_terms(q, width=snap.width)
    out, oc, _need = boolor(
        snap.keys, snap.blocks, snap.term_block_start, snap.counts,
        jnp2.asarray(qk), jnp2.asarray(np.full(len(queries), 2, dtype=np.int32)),
    )
    out, oc = np.asarray(out), np.asarray(oc)
    for i, q in enumerate(queries):
        want = sorted(set.union(*[truth[t] for t in q]))
        assert out[i, : oc[i]].tolist() == want, q


def test_sharded_prefix_search(built, mesh8):
    ii, truth, snap = built
    want = ii.prefix_search([b"t", bytes([40]), b"zzzz-none"])
    got = pm.sharded_prefix_search(snap, [b"t", bytes([40]), b"zzzz-none"], L=128)
    assert set(got.keys()) == set(want.keys())
    for p in want:
        assert got[p].tolist() == want[p].tolist(), p


def test_sharded_read_range(built, mesh8):
    ii, truth, snap = built
    from inverted_index_2_tpu import to_slice

    vocab = sorted(truth.keys())
    lo, hi = vocab[3], vocab[-5]
    want = [(tv.term, tv.values.tolist()) for tv in to_slice(ii.read(lo, hi))]
    got = [(t, v.tolist()) for t, v in pm.sharded_read_range(snap, lo, hi, L=128)]
    assert got == want
    want_all = [(tv.term, tv.values.tolist()) for tv in to_slice(ii.read(None, None))]
    got_all = [(t, v.tolist()) for t, v in pm.sharded_read_range(snap, None, None, L=128)]
    assert got_all == want_all


def test_sharded_long_lists_ladder(tmp_path, mesh8):
    """A posting list far beyond L must decode exactly on the mesh (ladder
    re-serve inside _decode_spans) for prefix and range reads."""
    ii = InvertedIndex(str(tmp_path))
    for v in range(1, 400):  # 399 values > L=128
        ii.put([b"xxbig", b"xxsmall"] if v <= 3 else [b"xxbig"], v)
    while ii.merge(2, 1000, 2) > 0:
        pass
    snap = pm.build_sharded_snapshot(ii, mesh8)
    got = pm.sharded_prefix_search(snap, [b"xx"], L=128)
    assert got[b"xx"].tolist() == list(range(1, 400))
    rows = {t: v.tolist() for t, v in pm.sharded_read_range(snap, None, None, L=128)}
    assert rows[b"xxbig"] == list(range(1, 400))
    assert rows[b"xxsmall"] == [1, 2, 3]
    stats = pm.partition_stats(snap)
    assert sum(1 for n in stats["n_terms_per_device"] if n) >= 1
    assert stats["padded_to"] >= max(stats["n_terms_per_device"])


def test_sharded_boolean_concat(built, mesh8):
    """Concat-decode boolean over the mesh: exact for any list length, no
    truncation signal needed; AND and OR vs Python-set truth."""
    ii, truth, snap = built
    import jax.numpy as jnp2

    vocab = sorted(truth.keys())
    rng = np.random.default_rng(5)
    Kk = 4
    queries = []
    for _ in range(10):
        k = int(rng.integers(1, Kk + 1))
        queries.append([vocab[i] for i in rng.choice(len(vocab), size=k, replace=False)])
    queries.append([vocab[0], b"zz-missing"])
    qk = np.zeros((16, Kk, snap.width + 1), dtype=np.uint32)
    kv = np.zeros(16, dtype=np.int32)
    for i, q in enumerate(queries):
        qk[i, : len(q)] = K.pack_terms(q, width=snap.width)
        kv[i] = len(q)
    for op in ("and", "or"):
        fn = pm.make_sharded_boolean_concat(snap, SB=8, op=op)
        out, oc = fn(jnp2.asarray(qk), jnp2.asarray(kv))
        out, oc = np.asarray(out), np.asarray(oc)
        for i, q in enumerate(queries):
            sets = [truth.get(t, set()) for t in q]
            want = sorted(set.intersection(*sets) if op == "and" else set.union(*sets))
            assert out[i, : oc[i]].tolist() == want, (op, q)


def test_sharded_boolean_concat_long_lists(tmp_path, mesh8):
    """Lists far beyond any padded L stay exact through the mesh concat."""
    ii = InvertedIndex(str(tmp_path))
    for v in range(1, 700):
        ii.put([b"qqbig"] + ([b"qqother"] if v % 5 == 0 else []), v)
    while ii.merge(2, 1000, 2) > 0:
        pass
    snap = pm.build_sharded_snapshot(ii, mesh8)
    import jax.numpy as jnp2

    qk = np.zeros((8, 2, snap.width + 1), dtype=np.uint32)
    qk[0] = K.pack_terms([b"qqbig", b"qqother"], width=snap.width)
    kv = np.zeros(8, dtype=np.int32)
    kv[0] = 2
    fn = pm.make_sharded_boolean_concat(snap, SB=8, op="and")
    out, oc = fn(jnp2.asarray(qk), jnp2.asarray(kv))
    want = [v for v in range(1, 700) if v % 5 == 0]
    assert np.asarray(out)[0, : int(oc[0])].tolist() == want
    fn = pm.make_sharded_boolean_concat(snap, SB=8, op="or")
    out, oc = fn(jnp2.asarray(qk), jnp2.asarray(kv))
    assert np.asarray(out)[0, : int(oc[0])].tolist() == list(range(1, 700))


def test_balanced_ranges(tmp_path, mesh8):
    """Contiguous data-balanced partitioning: an ASCII corpus (narrow
    shard-key band) spreads over all devices instead of landing on one."""
    ii = InvertedIndex(str(tmp_path))
    for i in range(256):
        ii.put([f"{chr(97 + i % 26)}{chr(97 + (i // 26) % 26)}x{i:03d}".encode()], i + 1)
    rs = pm.balanced_ranges(ii, 8)
    # full coverage, contiguous, in order
    assert rs[0].start == 0 and rs[-1].stop == 1024
    for a, b in zip(rs, rs[1:]):
        assert a.stop == b.start
    snap = pm.build_sharded_snapshot(ii, mesh8)
    stats = pm.partition_stats(snap)
    busy = sum(1 for n in stats["n_terms_per_device"] if n > 0)
    assert busy >= 6, stats  # was 1 device with key-uniform ranges
    assert stats["padding_overhead"] < 2.0, stats
    # correctness intact: global sorted order + lookups
    got = [t for t, _ in pm.sharded_read_range(snap, None, None, L=128)]
    assert got == sorted(got) and len(got) == 256


def test_balanced_ranges_by_blocks_fix_skew(tmp_path, mesh8):
    """Skewed corpus: a narrow key band carries LONG posting lists (many
    block rows), the rest short ones. Cutting ranges on BLOCK volume keeps
    the padded arena overhead ~1.x where term-count cuts leave it badly
    inflated."""
    ii = InvertedIndex(str(tmp_path))
    rng = np.random.default_rng(3)
    # heavy band: terms under prefix "aa" with ~600 postings each (5 blocks)
    heavy = [b"aa" + f"h{i:03d}".encode() for i in range(40)]
    for doc in range(1, 600):
        ii.put(heavy, doc)
    while ii.merge(2, 100, 2):  # fold into per-term long lists
        pass
    # light band: many single-posting terms spread over other prefixes
    for i in range(1600):
        a, b = 98 + (i % 24), 97 + (i // 24) % 26
        ii.put([bytes([a, b]) + f"l{i:04d}".encode()], 10_000 + i)

    rs_terms = pm.balanced_ranges(ii, 8, by="terms")
    rs_blocks = pm.balanced_ranges(ii, 8, by="blocks")

    def build_with(ranges, monkeypatch_mod=pm):
        orig = monkeypatch_mod.balanced_ranges
        monkeypatch_mod.balanced_ranges = (
            lambda idx, n, fanout=1024, by="blocks": ranges
        )
        try:
            return pm.build_sharded_snapshot(ii, mesh8)
        finally:
            monkeypatch_mod.balanced_ranges = orig

    st_blocks = pm.partition_stats(build_with(rs_blocks))
    st_terms = pm.partition_stats(build_with(rs_terms))
    assert st_blocks["block_padding_overhead"] <= 2.0, st_blocks
    # term-balanced cuts concentrate the heavy band on one device: its Bmax
    # pads every device and the block overhead blows up
    assert (
        st_blocks["block_padding_overhead"]
        < st_terms["block_padding_overhead"] * 0.67
    ), (st_blocks, st_terms)
    # serving still correct on the block-balanced split
    got = pm.sharded_prefix_search(build_with(rs_blocks), [b"aa"], L=1024)
    assert len(got[b"aa"]) == 599


def test_partition_tables_balance_and_structure(rng):
    """partition_tables cuts contiguous term ranges at ~equal BLOCK volume
    and each slice is a self-consistent HostTables (count words line up,
    offsets rebase exactly)."""
    from inverted_index_2_tpu.models.query_engine import build_host_tables

    n = 300
    terms = sorted(f"k{i:04d}".encode() for i in range(n))
    blob = b"".join(terms)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(t) for t in terms], out=offsets[1:])
    lens = rng.geometric(1 / 50, size=n).astype(np.int64) + 1
    lens[::37] = 2000  # skew: a few 16-block lists among 1-block ones
    vals = [
        np.sort(rng.choice(100_000, size=int(l), replace=False)).astype(np.uint32)
        for l in lens
    ]
    values = np.concatenate(vals)
    voffs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=voffs[1:])
    t = build_host_tables(np.frombuffer(blob, np.uint8), offsets, values, voffs)

    parts = pm.partition_tables(t, 4)
    assert sum(p.n_terms for p in parts) == n
    np.testing.assert_array_equal(
        np.concatenate([p.keys for p in parts if p.n_terms]), t.keys
    )
    rows = [int(p.tbs[-1]) for p in parts]
    ideal = sum(rows) / 4
    per_term_blocks = np.diff(t.tbs.astype(np.int64))
    # a cut lands within one term of the ideal boundary
    assert max(rows) <= ideal + int(per_term_blocks.max())
    for p in parts:
        if p.n_terms == 0:
            continue
        # every term's count word sits one before its first block
        firsts = p.flat[p.tbs[:-1].astype(np.int64)].astype(np.int64)
        np.testing.assert_array_equal(p.words[firsts - 1], p.counts)
        assert int(p.flat[0]) == 1  # words slice starts at the count word


def test_sharded_boolean_scatter_bit_identity(built, mesh8):
    """The reduce-scatter boolean (set op query-sharded, 1/D per device)
    must match the replicated make_sharded_boolean bit-for-bit — including
    at Q not divisible by the mesh size (internal pad) and with short
    k_valid rows."""
    ii, truth, snap = built
    import jax.numpy as jnp2

    vocab = sorted(truth.keys())
    rng = np.random.default_rng(9)
    for op in ("and", "or"):
        for nq in (12, 17, 8):  # 17: pads to 24 internally
            L = 128
            queries = [
                [vocab[i] for i in rng.choice(len(vocab), size=int(k), replace=False)]
                for k in rng.integers(1, 4, size=nq)
            ]
            Kk = 3
            qk = np.zeros((nq, Kk, snap.width + 1), dtype=np.uint32)
            kv = np.zeros(nq, dtype=np.int32)
            for i, q in enumerate(queries):
                qk[i, : len(q)] = K.pack_terms(q, width=snap.width)
                kv[i] = len(q)
            args = (
                snap.keys, snap.blocks, snap.term_block_start, snap.counts,
                jnp2.asarray(qk), jnp2.asarray(kv),
            )
            ref = pm.make_sharded_boolean(snap, L, op)(*args)
            got = pm.make_sharded_boolean_scatter(snap, L, op)(*args)
            for a, b, name in zip(ref, got, ("out", "oc", "need")):
                np.testing.assert_array_equal(
                    np.asarray(a), np.asarray(b), err_msg=(op, nq, name)
                )


def test_sharded_boolean_dual_scatter_bit_identity(mesh8, rng):
    """Dual-tier (main+delta) reduce-scatter boolean == the replicated dual
    formulation, including at Q not divisible by the mesh size."""
    from inverted_index_2_tpu.models.query_engine import (
        _empty_tables,
        build_host_tables,
    )

    def corpus(terms, seed):
        r = np.random.default_rng(seed)
        blob = b"".join(terms)
        offsets = np.zeros(len(terms) + 1, dtype=np.int64)
        np.cumsum([len(t) for t in terms], out=offsets[1:])
        lists = [
            np.unique(r.integers(0, 5000, size=int(r.integers(1, 90)), dtype=np.uint32))
            for _ in terms
        ]
        voffs = np.zeros(len(terms) + 1, dtype=np.int64)
        np.cumsum([len(l) for l in lists], out=voffs[1:])
        return build_host_tables(
            np.frombuffer(blob, np.uint8), offsets, np.concatenate(lists), voffs
        )

    main_terms = sorted(f"m{i:03d}".encode() for i in range(60))
    delta_terms = sorted(
        [f"d{i:03d}".encode() for i in range(20)] + main_terms[:10]
    )
    t_main = corpus(main_terms, 21)
    t_delta = corpus(delta_terms, 22)
    snap = pm.stack_tables(pm.partition_tables(t_main, 8), mesh8)
    dsnap = pm.stack_tables(
        [t_delta] + [_empty_tables(t_delta.width) for _ in range(7)], mesh8
    )

    allt = main_terms + [t for t in delta_terms if t not in main_terms]
    L = 128
    for op in ("and", "or"):
        for nq in (16, 17):
            qs = [
                [allt[i] for i in rng.choice(len(allt), size=2, replace=False)]
                for _ in range(nq)
            ]
            qk1 = np.zeros((nq, 2, snap.width + 1), dtype=np.uint32)
            qk2 = np.zeros((nq, 2, dsnap.width + 1), dtype=np.uint32)
            kv = np.full(nq, 2, dtype=np.int32)
            for i, q in enumerate(qs):
                qk1[i] = K.pack_terms(q, width=snap.width)
                qk2[i] = K.pack_terms(q, width=dsnap.width)
            import jax.numpy as jnp2

            args = (jnp2.asarray(qk1), jnp2.asarray(qk2), jnp2.asarray(kv))
            ref = pm.make_sharded_boolean_dual(snap, dsnap, L, op)(*args)
            got = pm.make_sharded_boolean_dual_scatter(snap, dsnap, L, op)(*args)
            for a, b, name in zip(ref, got, ("out", "oc", "need")):
                np.testing.assert_array_equal(
                    np.asarray(a), np.asarray(b), err_msg=(op, nq, name)
                )


def test_sharded_boolean_concat_scatter_bit_identity(built, mesh8):
    """The query-sharded concat reduction == the replicated concat form,
    including the 0xFFFFFFFF-member guard and Q padding."""
    ii, truth, snap = built
    import jax.numpy as jnp2

    vocab = sorted(truth.keys())
    rng = np.random.default_rng(29)
    for op in ("and", "or"):
        for nq in (16, 13):
            queries = [
                [vocab[i] for i in rng.choice(len(vocab), size=2, replace=False)]
                for _ in range(nq)
            ]
            qk = np.zeros((nq, 2, snap.width + 1), dtype=np.uint32)
            kv = np.full(nq, 2, dtype=np.int32)
            for i, q in enumerate(queries):
                qk[i] = K.pack_terms(q, width=snap.width)
            args = (jnp2.asarray(qk), jnp2.asarray(kv))
            ref = pm.make_sharded_boolean_concat(snap, 4, op)(*args)
            got = pm.make_sharded_boolean_concat_scatter(snap, 4, op)(*args)
            for a, b, name in zip(ref, got, ("out", "oc")):
                np.testing.assert_array_equal(
                    np.asarray(a), np.asarray(b), err_msg=(op, nq, name)
                )


def test_sharded_lookup_scatter_bit_identity(built, mesh8):
    """Reduce-scatter lookup == replicated-psum lookup (incl. internal Q
    padding at Q not divisible by the mesh size)."""
    ii, truth, snap = built
    import jax.numpy as jnp2

    terms = sorted(truth.keys())[:30] + [b"@@missing", b"zz-none", b"q"]
    for nq in (len(terms), 17):
        qk = jnp2.asarray(K.pack_terms(terms[:nq], width=snap.width))
        args = (snap.keys, snap.blocks, snap.term_block_start, snap.counts, qk)
        ref = pm.make_sharded_lookup(snap, 128)(*args)
        got = pm.make_sharded_lookup_scatter(snap, 128)(*args)
        for a, b, name in zip(ref, got, ("found", "vals", "n", "raw")):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b), err_msg=(nq, name)
            )
