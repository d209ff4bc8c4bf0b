"""QueryEngine AND/OR on the device concat path vs numpy set algebra.

The engine serves every boolean op through the exact concat-class path
(ops/concat_bool.py): each query's lists decode in full, whatever their
length, so results never depend on the fast-path pad L. These cases cover
the batch shapes that path must accept: long lists, K=1-only batches,
tombstones, q_buckets that are not multiples of 8, wide results, staged vs
one-shot, and batches past the staged-delegation and class-chunk sizes.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from inverted_index_2_tpu.models.query_engine import (
    QueryEngine,
    build_snapshot_arrays,
)


def _snap(lists):
    """Device snapshot of `lists` under terms t00000, t00001, ..."""
    voffs = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(l) for l in lists], out=voffs[1:])
    blob = b"".join(f"t{i:05d}".encode() for i in range(len(lists)))
    offs = np.arange(len(lists) + 1, dtype=np.int64) * 6
    return build_snapshot_arrays(blob, offs, np.concatenate(lists), voffs)


def _terms(n):
    return [f"t{i:05d}".encode() for i in range(n)]


def _expect(lists, q, op, removed=None):
    """Oracle: q holds term indices (or None for a missing term)."""
    sets = [set() if i is None else set(lists[i].tolist()) for i in q]
    out = set.intersection(*sets) if op == "and" else set.union(*sets)
    if removed is not None:
        out -= set(removed.tolist())
    return sorted(out)


def _queries(lists, rng, n, k_lo=2, k_hi=5):
    return [
        [int(i) for i in rng.choice(len(lists), size=int(rng.integers(k_lo, k_hi)),
                                    replace=False)]
        for _ in range(n)
    ]


@pytest.mark.parametrize("op", ["and", "or"])
def test_engine_and_matches_oracle(rng, op):
    """Lists both above and below L, an absent required term, a single
    term, and three-term queries."""
    lists = [
        np.unique(rng.integers(0, 2_000, size=int(s), dtype=np.uint32))
        for s in [400, 420, 380, 350, 500, 30, 410, 390]
    ]
    terms = _terms(len(lists))
    eng = QueryEngine(_snap(lists), L=256, q_bucket=8)
    qs = [[0, 1], [5, 2], [3, None], [4], [6, 7, 1]]
    got = eng.boolean(
        [[b"missing-term" if i is None else terms[i] for i in q] for q in qs], op)
    for q, g in zip(qs, got):
        assert g.dtype == np.uint32
        assert g.tolist() == _expect(lists, q, op), q


def test_engine_and_long_lists_exact(rng):
    """Lists many times L (multi-block, past every ladder level) intersect
    exactly: no truncation, no re-serve."""
    lists = [
        np.unique(rng.integers(0, 5_000, size=int(s), dtype=np.uint32))
        for s in [900, 950, 40, 800]
    ]
    terms = _terms(len(lists))
    eng = QueryEngine(_snap(lists), L=128, q_bucket=8)
    qs = [[0, 1], [2, 3], [0, 1, 3]]
    got = eng.boolean([[terms[i] for i in q] for q in qs], "and")
    for q, g in zip(qs, got):
        assert g.tolist() == _expect(lists, q, "and"), q
    assert len(got[0]) > 0


def test_engine_single_term_batch(rng):
    """A batch of ONLY single-term AND queries (K=1) serves each list."""
    lists = [
        np.unique(rng.integers(0, 2_000, size=int(s), dtype=np.uint32))
        for s in [40, 80, 120, 30]
    ]
    terms = _terms(len(lists))
    eng = QueryEngine(_snap(lists), L=256, q_bucket=8)
    got = eng.boolean([[terms[0]], [terms[2]], [b"missing"]], "and")
    assert np.array_equal(got[0], lists[0])
    assert np.array_equal(got[1], lists[2])
    assert len(got[2]) == 0


def test_engine_unaligned_L_normalizes(rng):
    """The constructor rounds L up to the 128-value block contract (every
    decode path works in 128-blocks). Results stay exact — L is only the
    fast-path pad."""
    lists = [np.unique(rng.integers(0, 500, size=60, dtype=np.uint32))
             for _ in range(3)]
    snap = _snap(lists)
    eng = QueryEngine(snap, L=1000, q_bucket=8)
    assert eng.L == 1024
    assert QueryEngine(snap, L=64, q_bucket=8).L == 128
    terms = _terms(len(lists))
    got = eng.boolean([[terms[0], terms[1]]], "and")
    assert np.array_equal(got[0], np.intersect1d(lists[0], lists[1]))


@pytest.mark.parametrize("op", ["and", "or"])
def test_engine_and_filter_removed(rng, op):
    """filter_removed=True drops the snapshot's tombstones from each result
    (and only with the flag)."""
    lists = [
        np.unique(rng.integers(0, 1_500, size=int(s), dtype=np.uint32))
        for s in [200, 220, 60]
    ]
    removed = np.unique(lists[0][::4]).astype(np.uint32)
    snap = _snap(lists)
    snap.removed = jnp.asarray(removed)
    terms = _terms(len(lists))
    eng = QueryEngine(snap, L=256, q_bucket=8)
    qs = [[0, 1], [2, 0]]
    tq = [[terms[i] for i in q] for q in qs]
    got = eng.boolean(tq, op, filter_removed=True)
    raw = eng.boolean(tq, op)
    for q, g, r in zip(qs, got, raw):
        assert g.tolist() == _expect(lists, q, op, removed), q
        assert r.tolist() == _expect(lists, q, op), q


def test_engine_and_adversarial_shapes(rng):
    """Identical lists (result = the whole list), counts at exactly L and
    L+1, the same term twice, and a genuine 0xFFFFFFFF member (the
    compaction sentinel's value)."""
    L = 256
    full = np.sort(rng.choice(10_000, size=L, replace=False)).astype(np.uint32)
    over = np.sort(rng.choice(10_000, size=L + 1, replace=False)).astype(np.uint32)
    with_ff = np.unique(
        np.concatenate([full[:50], np.array([0xFFFFFFFF], np.uint32)])
    )
    lists = [full, full.copy(), over, with_ff, with_ff.copy()]
    terms = _terms(len(lists))
    eng = QueryEngine(_snap(lists), L=L, q_bucket=8)
    cases = [[0, 1], [3, 4], [0, 0], [2, 2], [2, 0], [3]]
    for op in ("and", "or"):
        got = eng.boolean([[terms[i] for i in q] for q in cases], op)
        for q, g in zip(cases, got):
            assert g.tolist() == _expect(lists, q, op), (op, q)


def test_engine_q_bucket_not_multiple_of_8(rng):
    """A q_bucket not divisible by 8 pads instead of raising."""
    lists = [
        np.unique(rng.integers(0, 2_000, size=int(s), dtype=np.uint32))
        for s in [50, 80, 120, 60]
    ]
    terms = _terms(len(lists))
    eng = QueryEngine(_snap(lists), L=256, q_bucket=12)
    got = eng.boolean([[terms[0], terms[1]], [terms[2], terms[3]]], "and")
    for q, g in zip([[0, 1], [2, 3]], got):
        assert np.array_equal(g, np.intersect1d(lists[q[0]], lists[q[1]]))
    staged = eng.boolean_staged([[[terms[0], terms[1]]] * 13], "and")
    for g in staged[0]:
        assert np.array_equal(g, np.intersect1d(lists[0], lists[1]))


def test_engine_and_wide_results(rng):
    """AND results as wide as whole lists (identical lists) are served in
    full, one-shot and staged, rows and columnar."""
    big = np.unique(rng.integers(0, 4_000, size=200, dtype=np.uint32))
    lists = [big, big.copy(),
             np.unique(rng.integers(0, 2_000, size=30, dtype=np.uint32))]
    terms = _terms(len(lists))
    eng = QueryEngine(_snap(lists), L=128, q_bucket=8)
    qs = [[terms[0], terms[1]], [terms[0], terms[2]]]
    want = [big, np.intersect1d(big, lists[2])]
    got = eng.boolean(qs, "and")
    (vals, voffs), = eng.boolean_staged([qs], "and", columnar=True)
    for i, w in enumerate(want):
        assert np.array_equal(got[i], w)
        assert np.array_equal(vals[voffs[i]:voffs[i + 1]], w)


@pytest.mark.parametrize("op", ["and", "or"])
def test_engine_boolean_staged_matches_plain(rng, op):
    """boolean_staged (pipelined stream) is result-identical to boolean()
    per batch and to the oracle, including tombstone filtering."""
    lists = [
        np.unique(rng.integers(0, 3_000, size=int(s), dtype=np.uint32))
        for s in [400, 420, 30, 350, 120, 60, 500, 90]
    ]
    removed = np.unique(np.concatenate([l[::7] for l in lists])).astype(np.uint32)
    snap = _snap(lists)
    snap.removed = jnp.asarray(removed)
    terms = _terms(len(lists))
    eng = QueryEngine(snap, L=256, q_bucket=8)
    rngq = np.random.default_rng(7)
    idx = [_queries(lists, rngq, 6) for _ in range(2)]
    idx[0].append([0, 6])
    batches = [[[terms[i] for i in q] for q in b] for b in idx]
    batches[1].append([terms[2], b"zz-missing"])
    idx[1].append([2, None])
    staged = eng.boolean_staged(batches, op, filter_removed=True)
    columnar = eng.boolean_staged(batches, op, filter_removed=True,
                                  columnar=True)
    for bi, qs in enumerate(batches):
        plain = eng.boolean(qs, op, filter_removed=True)
        vals, voffs = columnar[bi]
        assert len(voffs) == len(qs) + 1
        for qi in range(len(qs)):
            want = _expect(lists, idx[bi][qi], op, removed)
            assert plain[qi].tolist() == want, (bi, qi)
            assert staged[bi][qi].tolist() == want, (bi, qi)
            assert vals[voffs[qi]: voffs[qi + 1]].tolist() == want, (bi, qi)


def test_engine_large_batch(rng, monkeypatch):
    """A batch past 8192 queries (one-shot boolean delegates it to the
    staged stream) is exact, and so is one split into many class chunks
    (the chunk budget shrunk so a small batch spans several)."""
    from inverted_index_2_tpu.models import staged as staged_mod

    lists = [
        np.unique(rng.integers(0, 2_000, size=int(s), dtype=np.uint32))
        for s in [150, 180, 40, 120, 90, 60]
    ]
    terms = _terms(len(lists))
    eng = QueryEngine(_snap(lists), L=256, q_bucket=256)
    rq = np.random.default_rng(3)
    idx = _queries(lists, rq, 8200, 2, 4)
    got = eng.boolean([[terms[i] for i in q] for q in idx], "and")
    assert len(got) == 8200
    memo = {}
    for q, g in zip(idx, got):
        key = tuple(sorted(q))
        if key not in memo:
            memo[key] = _expect(lists, q, "and")
        assert g.tolist() == memo[key], q
    monkeypatch.setattr(staged_mod, "_RESERVE_BUDGET", 8 * 8 * 128)
    small = idx[:40]
    staged = eng.boolean_staged([[[terms[i] for i in q] for q in small]], "and")
    for q, g in zip(small, staged[0]):
        assert g.tolist() == _expect(lists, q, "and"), q
