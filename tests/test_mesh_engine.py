"""MeshQueryEngine vs single-chip QueryEngine: bit-identity on the same
index (tombstones included), incremental refresh, ladder re-serves — the
mesh serving-parity contract."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from inverted_index_2_tpu import InvertedIndex
from inverted_index_2_tpu.models.query_engine import QueryEngine
from inverted_index_2_tpu.parallel import MeshQueryEngine
from inverted_index_2_tpu.parallel import mesh as pm


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return pm.default_mesh(8)


def _build_index(tmp, rng, n_docs=60, removed=(3, 7, 11, 20)):
    ii = InvertedIndex(str(tmp))
    vocab = [bytes([a, b]) + f"t{i}".encode() for i, (a, b) in enumerate(
        (int(x), int(y)) for x, y in rng.integers(32, 127, size=(90, 2))
    )]
    for doc in range(1, n_docs):
        k = int(rng.integers(1, 6))
        terms = [vocab[i] for i in rng.choice(len(vocab), size=k, replace=False)]
        ii.put(terms, doc)
    ii.put_removed(np.asarray(removed, dtype=np.uint32))
    return ii, vocab


def _assert_rows_equal(a, b, ctx):
    assert len(a) == len(b), ctx
    for i, (x, y) in enumerate(zip(a, b)):
        if x is None or y is None:
            assert x is None and y is None, (ctx, i)
        else:
            assert np.array_equal(x, y), (ctx, i)


def test_mesh_engine_bit_identity(tmp_path, mesh8):
    rng = np.random.default_rng(11)
    ii, vocab = _build_index(tmp_path, rng)
    chip = QueryEngine.from_index(ii, L=128, q_bucket=16)
    mesh_eng = MeshQueryEngine(ii, mesh=mesh8, L=128, q_bucket=16)
    assert mesh_eng.warmup(k_max=3) > 0

    terms = vocab[:25] + [b"@@missing"]
    for filt in (False, True):
        _assert_rows_equal(
            mesh_eng.lookup(terms, filter_removed=filt),
            chip.lookup(terms, filter_removed=filt),
            ("lookup", filt),
        )
    queries = [
        [vocab[0], vocab[1]],
        [vocab[2], vocab[3], vocab[4]],
        [vocab[5], b"@@missing"],
        [vocab[6]],
    ]
    for op in ("and", "or"):
        for filt in (False, True):
            _assert_rows_equal(
                mesh_eng.boolean(queries, op, filter_removed=filt),
                chip.boolean(queries, op, filter_removed=filt),
                (op, filt),
            )
    # prefix search parity (not tombstone-filtered, like the reference)
    prefixes = [v[:2] for v in vocab[:10]] + [b"\x00\x00nope"]
    got = mesh_eng.prefix_search(prefixes)
    want = chip.prefix_search(prefixes)
    assert set(got) == set(want)
    for p in want:
        assert np.array_equal(got[p], want[p]), p
    # range read parity
    got_rows = [(t, v.tolist()) for t, v in mesh_eng.read_range(None, None)]
    want_rows = [(t, v.tolist()) for t, v in chip.read_range(None, None)]
    assert got_rows == want_rows


def test_mesh_engine_refresh_delta_and_promote(tmp_path, mesh8):
    rng = np.random.default_rng(13)
    ii, vocab = _build_index(tmp_path, rng, n_docs=40, removed=(2,))
    eng = MeshQueryEngine(ii, mesh=mesh8, L=128, q_bucket=16)
    assert eng.refresh(ii) is False  # fingerprint no-op

    # additive change -> delta tier, results track the live index
    ii.put([vocab[0], b"zz-new-term"], 999)
    assert eng.refresh(ii) is True
    assert eng.delta is not None
    chip = QueryEngine.from_index(ii, L=128, q_bucket=16)
    _assert_rows_equal(
        eng.lookup([vocab[0], b"zz-new-term"]),
        chip.lookup([vocab[0], b"zz-new-term"]),
        "delta-lookup",
    )
    for op in ("and", "or"):
        _assert_rows_equal(
            eng.boolean([[vocab[0], b"zz-new-term"]], op, filter_removed=True),
            chip.boolean([[vocab[0], b"zz-new-term"]], op, filter_removed=True),
            ("delta", op),
        )
    # tombstone-only change refreshes the removed array without a rebuild
    ii.put_removed(np.asarray([999], dtype=np.uint32))
    assert eng.refresh(ii) is True
    assert 999 in np.asarray(eng._removed).tolist()
    got = eng.boolean([[vocab[0], b"zz-new-term"]], "and", filter_removed=True)
    assert 999 not in got[0].tolist()

    # compaction (segments vanish) -> full rebuild, delta folds in
    while ii.merge(2, 100, 2):
        pass
    assert eng.refresh(ii) is True
    assert eng.delta is None
    chip2 = QueryEngine.from_index(ii, L=128, q_bucket=16)
    _assert_rows_equal(
        eng.lookup([vocab[0], b"zz-new-term"]),
        chip2.lookup([vocab[0], b"zz-new-term"]),
        "post-merge",
    )


def test_mesh_engine_from_checkpoint(tmp_path, mesh8):
    """Warm-started mesh serving (checkpoint -> partition_tables ->
    stack_tables) must be indistinguishable from a fresh build, and a
    stale checkpoint must reconcile through refresh."""
    from inverted_index_2_tpu.models.checkpoint import save_checkpoint

    rng = np.random.default_rng(17)
    ii, vocab = _build_index(tmp_path / "idx", rng)
    path = str(tmp_path / "serve.ckpt")
    save_checkpoint(ii, path)

    fresh = MeshQueryEngine(ii, mesh=mesh8, L=128, q_bucket=16)
    warm = MeshQueryEngine.from_checkpoint(
        path, index=ii, mesh=mesh8, L=128, q_bucket=16
    )
    assert warm.delta is None  # fingerprint matched: no refresh work
    terms = vocab[:20] + [b"@@missing"]
    for filt in (False, True):
        _assert_rows_equal(
            warm.lookup(terms, filter_removed=filt),
            fresh.lookup(terms, filter_removed=filt),
            ("ckpt-lookup", filt),
        )
    queries = [
        [vocab[0], vocab[1]],
        [vocab[2], vocab[3], vocab[4]],
        [vocab[5], b"@@missing"],
    ]
    for op in ("and", "or"):
        _assert_rows_equal(
            warm.boolean(queries, op, filter_removed=True),
            fresh.boolean(queries, op, filter_removed=True),
            ("ckpt", op),
        )
    got_rows = [(t, v.tolist()) for t, v in warm.read_range(None, None)]
    want_rows = [(t, v.tolist()) for t, v in fresh.read_range(None, None)]
    assert got_rows == want_rows

    # stale checkpoint: additive drift -> delta tier at load
    ii.put([vocab[1], b"zz-late"], 500)
    warm2 = MeshQueryEngine.from_checkpoint(
        path, index=ii, mesh=mesh8, L=128, q_bucket=16
    )
    assert warm2.delta is not None
    chip = QueryEngine.from_index(ii, L=128, q_bucket=16)
    _assert_rows_equal(
        warm2.lookup([vocab[1], b"zz-late"]),
        chip.lookup([vocab[1], b"zz-late"]),
        "ckpt-delta",
    )

    # apply_removed checkpoints are rejected for mesh serving
    p2 = str(tmp_path / "purged.ckpt")
    save_checkpoint(ii, p2, apply_removed=True)
    with pytest.raises(ValueError):
        MeshQueryEngine.from_checkpoint(p2, mesh=mesh8)

    # without an index: serve the checkpointed state as-is
    warm3 = MeshQueryEngine.from_checkpoint(path, mesh=mesh8, L=128, q_bucket=16)
    _assert_rows_equal(warm3.lookup(terms), fresh.lookup(terms), "ckpt-noindex")


def test_mesh_engine_boolean_staged(tmp_path, mesh8):
    """Mesh stream serving (boolean_staged) is result-identical to mesh
    boolean() per batch — ladder re-serves and tombstone filtering
    included — and the columnar pair carries the same values."""
    rng = np.random.default_rng(17)
    ii, vocab = _build_index(tmp_path, rng, n_docs=90)
    # a long list to force the ladder (L=128 below)
    for v in range(100, 300):
        ii.put([vocab[0], vocab[1]], v)
    eng = MeshQueryEngine(ii, mesh=mesh8, L=128, q_bucket=8)
    rq = np.random.default_rng(23)
    batches = []
    for _ in range(3):
        qs = []
        for _ in range(6):
            k = int(rq.integers(1, 4))
            qs.append([vocab[i] for i in rq.choice(40, size=k, replace=False)])
        batches.append(qs)
    batches[0].append([vocab[0], vocab[1]])  # > L: deferred re-serve
    batches.append([])
    for op in ("and", "or"):
        for fr in (False, True):
            staged = eng.boolean_staged(batches, op, filter_removed=fr)
            col = eng.boolean_staged(batches, op, filter_removed=fr,
                                     columnar=True)
            for bi, qs in enumerate(batches):
                plain = eng.boolean(qs, op, filter_removed=fr)
                _assert_rows_equal(staged[bi], plain, (op, fr, bi))
                vals, voffs = col[bi]
                assert len(voffs) == len(qs) + 1
                for qi in range(len(qs)):
                    assert np.array_equal(
                        vals[voffs[qi]: voffs[qi + 1]], plain[qi]
                    ), (op, fr, bi, qi)


def test_mesh_engine_boolean_staged_pagination(tmp_path, mesh8):
    """prefix_p on the mesh stream matches the single-chip pagination
    contract: (values, voffs, counts) with TRUE counts and the first-P
    values — exact through ladder re-serves (need > L), tombstone
    filtering, and the delta-tier per-batch fallback."""
    rng = np.random.default_rng(31)
    ii, vocab = _build_index(tmp_path, rng, n_docs=90)
    for v in range(100, 300):  # > L=128: deferred exact re-serve
        ii.put([vocab[0], vocab[1]], v)
    eng = MeshQueryEngine(ii, mesh=mesh8, L=128, q_bucket=8)
    rq = np.random.default_rng(29)
    batches = []
    for _ in range(2):
        qs = []
        for _ in range(6):
            k = int(rq.integers(1, 4))
            qs.append([vocab[i] for i in rq.choice(40, size=k, replace=False)])
        batches.append(qs)
    batches[0].append([vocab[0], vocab[1]])   # re-serve row
    batches[1].append([b"zz-missing", vocab[2]])
    batches.append([])
    with pytest.raises(ValueError):
        eng.boolean_staged(batches, "or", prefix_p=4)

    def check(tag):
        for op in ("and", "or"):
            for fr in (False, True):
                for P in (3, 16):
                    got = eng.boolean_staged(
                        batches, op, filter_removed=fr,
                        columnar=True, prefix_p=P)
                    for bi, qs in enumerate(batches):
                        plain = eng.boolean(qs, op, filter_removed=fr)
                        vals, voffs, counts = got[bi]
                        assert len(voffs) == len(qs) + 1
                        for qi, row in enumerate(plain):
                            assert counts[qi] == len(row), (
                                tag, op, fr, P, bi, qi)
                            assert np.array_equal(
                                vals[voffs[qi]: voffs[qi + 1]], row[:P]
                            ), (tag, op, fr, P, bi, qi)

    check("main")
    # delta window live: pagination serves through the exact fallback
    ii.put([vocab[2], b"delta-new"], 999)
    assert eng.refresh(ii) is True and eng.delta is not None
    batches[1].append([b"delta-new", vocab[2]])
    check("delta")


def test_mesh_engine_lookup_staged(tmp_path, mesh8):
    """Mesh stream lookup agrees with mesh lookup() per term — misses are
    count-0 rows, prefix_p returns true counts + first-P values."""
    rng = np.random.default_rng(41)
    ii, vocab = _build_index(tmp_path, rng, n_docs=80)
    eng = MeshQueryEngine(ii, mesh=mesh8, L=128, q_bucket=8)
    batches = [vocab[:7] + [b"zz-missing"], vocab[7:15], []]
    for fr in (False, True):
        plain = [eng.lookup(b, filter_removed=fr) for b in batches]
        rows = eng.lookup_staged(batches, filter_removed=fr)
        pre = eng.lookup_staged(batches, filter_removed=fr,
                                columnar=True, prefix_p=4)
        for bi, b in enumerate(batches):
            for qi, t in enumerate(b):
                want = plain[bi][qi]
                want = (np.zeros(0, np.uint32) if want is None else want)
                assert np.array_equal(rows[bi][qi], want), (fr, bi, qi)
                vals, voffs, counts = pre[bi]
                assert counts[qi] == len(want), (fr, bi, qi)
                assert np.array_equal(
                    vals[voffs[qi]: voffs[qi + 1]], want[:4]), (fr, bi, qi)
