"""Smoke run of the index's main path on one GPU, every answer checked.

    python chip_smoke.py             # phases 0-3 on one GPU
    python chip_smoke.py --mesh 4    # the sharded phase alone, on 4 GPUs

Phase 0  the device: JAX must report a GPU (there is no CPU fallback), the
         card's name and power limit, and the native host codec.
Phase 1  write path (BASELINE configs 1 + 2): 1M term occurrences ingested
         through InvertedIndex.put_many in 250k batches, 16 more segments,
         tombstones, merge-until-zero through the device merge, then
         read(None, None) and prefix_search against a numpy reference.
         QueryEngine.from_index serves the result (the user entry point).
Phase 2  device serving at config-5 scale: bench.gen_corpus(10M terms, mean
         posting length 10), a QueryEngine without retained host tables
         (every op on the device): lookup, lookup_staged, boolean_staged
         AND / OR (full and prefix_p=32), one-shot boolean, prefix_search.
Phase 3  config-3 shape: 200k terms x mean posting length 1k, staged AND and
         OR over the bench's 2-8-term query mix.
--mesh N one config-4-shape index (64 hash-routed shards) served by
         MeshQueryEngine over N devices, compared bit-for-bit with a
         single-device QueryEngine and the numpy reference.

Every result is a set of u32 doc ids, so every comparison is exact equality
with a numpy reference built from the generated data (np.intersect1d /
np.union1d / np.setdiff1d), independent of the code under test. Each phase
is a function of its sizes, so the tests run it on the CPU at tiny sizes;
main() uses the sizes above. Any failed check raises, and the script exits
non-zero without printing its last line:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))


def log(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# reference and checks
# ---------------------------------------------------------------------------


class Lists:
    """Posting lists of a generated corpus: term i holds
    values[voffs[i]:voffs[i+1]] (sorted unique u32), term bytes terms[i]."""

    def __init__(self, terms: np.ndarray, values: np.ndarray, voffs: np.ndarray):
        self.terms = terms          # (n,) fixed-width bytes, sorted
        self.values = values
        self.voffs = voffs

    @classmethod
    def from_corpus(cls, blob: bytes, offsets: np.ndarray, values, voffs):
        width = int(offsets[1] - offsets[0])
        assert np.all(np.diff(offsets) == width), "fixed-width terms expected"
        terms = np.frombuffer(blob, dtype=f"S{width}")
        return cls(terms, values, voffs)

    def __len__(self) -> int:
        return len(self.terms)

    def term(self, i: int) -> bytes:
        return bytes(self.terms[i])

    def get(self, i: int) -> np.ndarray:
        return self.values[self.voffs[i]:self.voffs[i + 1]]

    def expect(self, q, op: str, removed=None) -> np.ndarray:
        """Reference result of one query (term indices) under `op`."""
        out = self.get(q[0])
        for i in q[1:]:
            f = np.intersect1d if op == "and" else np.union1d
            out = f(out, self.get(i))
        if removed is not None:
            out = np.setdiff1d(out, removed)
        return out.astype(np.uint32)

    def prefix_expect(self, p: bytes):
        width = self.terms.dtype.itemsize
        lo = int(np.searchsorted(self.terms, p, side="left"))
        hi = int(np.searchsorted(self.terms, p.ljust(width, b"\xff"), side="right"))
        if hi <= lo:
            return None
        return np.unique(self.values[self.voffs[lo]:self.voffs[hi]])


def check_rows(what: str, got, want) -> None:
    """Exact equality of per-query result rows (u32 sets)."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} results for {len(want)} queries")
    for i, (g, w) in enumerate(zip(got, want)):
        g = np.zeros(0, np.uint32) if g is None else np.asarray(g)
        if g.dtype != np.uint32 or not np.array_equal(g, w):
            raise AssertionError(
                f"{what}: query {i} differs: got {g[:8]} ({len(g)}), "
                f"want {w[:8]} ({len(w)})"
            )


def check_columnar(what: str, got, want) -> None:
    vals, voffs = got[0], got[1]
    check_rows(what, [vals[voffs[i]:voffs[i + 1]] for i in range(len(voffs) - 1)],
               want)


def check_paged(what: str, got, want, P: int) -> None:
    vals, voffs, counts = got
    if not np.array_equal(counts, [len(w) for w in want]):
        raise AssertionError(f"{what}: true counts differ")
    check_rows(what, [vals[voffs[i]:voffs[i + 1]] for i in range(len(voffs) - 1)],
               [w[:P] for w in want])


def check_prefix(what: str, got: dict, lists: Lists, prefixes) -> None:
    for p in prefixes:
        w = lists.prefix_expect(p)
        if w is None:
            if p in got:
                raise AssertionError(f"{what}: {p!r} matched nothing, got a result")
        elif p not in got or not np.array_equal(got[p], w):
            raise AssertionError(f"{what}: prefix {p!r} differs")


def query_stream(n_terms: int, nb: int, Q: int, seed: int):
    """The bench's uniform query mix (bench._boolean_stream): 2-8 distinct
    terms per query, as term indices."""
    import bench

    return bench._boolean_stream(np.arange(n_terms), nb, Q, seed=seed)


def hit_queries(n_terms: int, Q: int, seed: int):
    """Queries with non-empty AND results: a single term, or one term
    twice."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, n_terms, size=Q)
    return [[int(i)] if j % 2 else [int(i), int(i)] for j, i in enumerate(t)]


def to_terms(lists: Lists, batch):
    return [[lists.term(i) for i in q] for q in batch]


def timed(fn):
    t0 = time.monotonic()
    out = fn()
    return out, time.monotonic() - t0


def memory_line(devices) -> str:
    parts = []
    for d in devices:
        st = d.memory_stats() or {}
        if st:
            parts.append(
                f"{d.id}: peak {st.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB "
                f"of {st.get('bytes_limit', 0) / 2**30:.2f} GiB"
            )
    return "device memory " + ("; ".join(parts) if parts else "not reported")


# ---------------------------------------------------------------------------
# phase 0: the device
# ---------------------------------------------------------------------------


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` (one line per card)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip()


def phase_device() -> dict:
    import jax

    from inverted_index_2_tpu.codec import native

    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    log(f"[phase 0] devices: {info}")
    log(f"[phase 0] native codec loaded: {native.available()}")
    return info


# ---------------------------------------------------------------------------
# phase 1: write path
# ---------------------------------------------------------------------------


def _vocab(n: int, rng, prefix: bytes, width: int = 12) -> np.ndarray:
    raw = rng.integers(97, 123, size=(n, width), dtype=np.uint8)
    raw[:, : len(prefix)] = np.frombuffer(prefix, np.uint8)
    return np.unique(raw.view(f"S{width}").ravel())


def _put_docs(ii, vocab_list, term_idx: np.ndarray, doc_terms: int,
              first_value: int) -> int:
    """One put_many call: consecutive runs of `doc_terms` occurrences form
    documents with consecutive values. Returns the next free value."""
    docs = []
    v = first_value
    for s in range(0, len(term_idx), doc_terms):
        docs.append(([vocab_list[i] for i in term_idx[s:s + doc_terms]], v))
        v += 1
    ii.put_many(docs)
    return v


def phase_write_path(basedir: str, n_occ: int = 1_000_000, batch: int = 250_000,
                     extra_segments: int = 16, extra_occ: int = 100_000,
                     vocab: int = 200_000, doc_terms: int = 50, seed: int = 1):
    """Ingest, tombstone, merge (through the device merge), read back.
    Returns (index, reference Lists of the merged index)."""
    from inverted_index_2_tpu import InvertedIndex, to_slice
    from inverted_index_2_tpu import shard as shard_mod

    rng = np.random.default_rng(seed)
    # one shard, as bench.py's ingest shape: a common 2-byte prefix
    voc = _vocab(vocab, rng, b"aa")
    voc_list = [bytes(t) for t in voc]
    ii = InvertedIndex(basedir)
    occ_t, occ_v = [], []
    t0 = time.monotonic()
    value = 1
    sizes = [batch] * (n_occ // batch) + [extra_occ] * extra_segments
    for size in sizes:
        idx = rng.integers(0, len(voc), size=size)
        nxt = _put_docs(ii, voc_list, idx, doc_terms, value)
        occ_t.append(idx)
        occ_v.append(value + np.arange(size) // doc_terms)
        value = nxt
    ingest_s = time.monotonic() - t0
    occ_t = np.concatenate(occ_t).astype(np.int64)
    occ_v = np.concatenate(occ_v).astype(np.int64)
    log(f"[phase 1] ingest: {len(occ_t)} term occurrences, {value - 1} docs, "
        f"{len(sizes)} put_many calls in {ingest_s:.2f} s")

    removed = np.sort(rng.choice(np.arange(1, value), size=max(1, (value - 1) // 100),
                                 replace=False)).astype(np.uint32)
    ii.put_removed(removed)

    merged_shards = set()
    max_est = 0
    for sh in ii._snapshot():
        segs = sh.segments.snapshot()
        if len(segs) >= 2:
            merged_shards.add(sh.get_key())
            est = sum(shard_mod._estimate_values(s.view) for s in segs)
            max_est = max(max_est, est)
    if max_est < shard_mod.DEVICE_MERGE_MIN_VALUES:
        raise AssertionError(
            f"largest merge holds {max_est} values, below the device-merge "
            f"threshold {shard_mod.DEVICE_MERGE_MIN_VALUES}")
    t0 = time.monotonic()
    rounds = 0
    while ii.merge(2, 1000, 1) > 0:
        rounds += 1
    merge_s = time.monotonic() - t0
    log(f"[phase 1] merge: {rounds} rounds in {merge_s:.2f} s, largest "
        f"{max_est} values (device merge from "
        f"{shard_mod.DEVICE_MERGE_MIN_VALUES})")

    # reference: unique (term, value) pairs; merge purged the tombstones in
    # every shard it merged, and reads never apply them
    key = np.unique(occ_t * (1 << 32) + occ_v)
    term_of = key >> 32
    val = (key & 0xFFFFFFFF).astype(np.uint32)
    purged = np.array([shard_mod.shard_key(bytes(voc[t])) in merged_shards
                       for t in range(len(voc))])
    keep = ~(purged[term_of] & np.isin(val, removed))
    term_of, val = term_of[keep], val[keep]
    present, starts = np.unique(term_of, return_index=True)
    voffs = np.append(starts, len(val)).astype(np.int64)
    ref = Lists(voc[present], val, voffs)

    t0 = time.monotonic()
    got = to_slice(ii.read(None, None))
    read_s = time.monotonic() - t0
    if [tv.term for tv in got] != [bytes(t) for t in ref.terms]:
        raise AssertionError("read(None, None): term list differs")
    check_rows("read(None, None)", [tv.values for tv in got],
               [ref.get(i) for i in range(len(ref))])
    prefixes = [ref.term(int(i))[: int(k)] for i, k in zip(
        rng.integers(0, len(ref), 300), rng.integers(3, 7, 300))] + [b"zz", b"aa\xff"]
    check_prefix("InvertedIndex.prefix_search", ii.prefix_search(prefixes),
                 ref, prefixes)
    log(f"[phase 1] read(None, None): {len(got)} terms in {read_s:.2f} s; "
        f"prefix_search: {len(prefixes)} prefixes; all equal to the reference")
    return ii, ref


# ---------------------------------------------------------------------------
# phase 2 / 3: device serving
# ---------------------------------------------------------------------------


def serve_from_index(ii, ref: Lists, n_queries: int = 2000, seed: int = 5) -> None:
    """QueryEngine.from_index on the phase-1 index (host tables retained;
    the engine routes each op)."""
    from inverted_index_2_tpu.models.query_engine import QueryEngine

    rng = np.random.default_rng(seed)
    (eng, build_s) = timed(lambda: QueryEngine.from_index(ii))
    n = len(ref)
    look = rng.integers(0, n, size=n_queries)
    check_rows("from_index lookup", eng.lookup([ref.term(i) for i in look]),
               [ref.get(i) for i in look])
    qs = query_stream(n, 1, n_queries // 2, seed)[0] + hit_queries(n, n_queries // 2, seed)
    for op in ("and", "or"):
        check_rows(f"from_index boolean {op}", eng.boolean(to_terms(ref, qs), op),
                   [ref.expect(q, op) for q in qs])
    lo, hi = sorted(rng.integers(0, n, size=2))
    got = list(eng.read_range(ref.term(lo), ref.term(hi)))
    if [t for t, _ in got] != [ref.term(i) for i in range(lo, hi + 1)]:
        raise AssertionError("from_index read_range: terms differ")
    check_rows("from_index read_range", [v for _, v in got],
               [ref.get(i) for i in range(lo, hi + 1)])
    log(f"[phase 2] QueryEngine.from_index: built in {build_s:.2f} s; "
        f"lookup, AND, OR ({len(qs)} queries each) and read_range "
        f"({hi - lo + 1} terms) equal the reference")


def _timed_stream(label: str, fn, n_queries: int, card: str):
    """Run `fn` twice: cold (compiles included) and cached. Returns the
    second result."""
    _, cold = timed(fn)
    out, warm = timed(fn)
    log(f"    {label}: cold {cold:.3f} s, cached {warm:.3f} s, "
        f"{n_queries / warm:.0f} queries/s ({card})")
    return out


def serve_corpus(tag: str, corpus, L: int, nb: int, Q: int, seed: int,
                 card: str, n_removed: int = 1000, oneshot: bool = True,
                 lookups: bool = True):
    """Freeze a generated corpus (bench.gen_corpus tuple) onto the device
    and check every serving op there against the reference."""
    import jax

    from inverted_index_2_tpu.models.query_engine import (
        QueryEngine, build_host_tables, upload_tables)

    blob, offsets, values, voffs = corpus
    ref = Lists.from_corpus(blob, offsets, values, voffs)
    rng = np.random.default_rng(seed)
    removed = np.unique(rng.choice(values, size=n_removed)).astype(np.uint32)
    t0 = time.monotonic()
    tables = build_host_tables(blob, offsets, values, voffs, removed)
    tables_s = time.monotonic() - t0
    t0 = time.monotonic()
    snap = upload_tables(tables)
    jax.block_until_ready(snap.blocks)
    upload_s = time.monotonic() - t0
    del tables
    log(f"[{tag}] {len(ref)} terms, {int(voffs[-1])} postings: host tables "
        f"{tables_s:.2f} s, upload {upload_s:.2f} s, snapshot "
        f"{snap.device_bytes()} device bytes (arena {tuple(snap.blocks.shape)})")

    # tables=None: no host route exists, every op is served on the device
    eng = QueryEngine(snap, L=L, q_bucket=Q)
    n_prog, warm_s = timed(lambda: eng.warmup(k_max=8))
    log(f"[{tag}] warmup: {n_prog} programs in {warm_s:.2f} s")
    n = len(ref)
    stream = query_stream(n, nb, Q, seed)
    hits = hit_queries(n, Q, seed + 1)
    tstream = [to_terms(ref, b) for b in stream]
    nq = nb * Q

    for op in ("and", "or"):
        got = _timed_stream(f"boolean_staged {op}", lambda: eng.boolean_staged(
            tstream, op, columnar=True), nq, card)
        for b, g in zip(stream, got):
            check_columnar(f"{tag} staged {op}", g, [ref.expect(q, op) for q in b])
        got = eng.boolean_staged([to_terms(ref, hits)], op, columnar=True,
                                 filter_removed=True)[0]
        check_columnar(f"{tag} staged {op} hits filter_removed", got,
                       [ref.expect(q, op, removed) for q in hits])
        got = eng.boolean_staged(tstream[:1], op, columnar=True,
                                 filter_removed=True)[0]
        check_columnar(f"{tag} staged {op} filter_removed", got,
                       [ref.expect(q, op, removed) for q in stream[0]])
    got = _timed_stream("boolean_staged or prefix_p=32", lambda: eng.boolean_staged(
        tstream, "or", columnar=True, prefix_p=32), nq, card)
    for b, g in zip(stream, got):
        check_paged(f"{tag} staged or prefix_p", g,
                    [ref.expect(q, "or") for q in b], 32)
    got = eng.boolean_staged([to_terms(ref, hits)], "and", columnar=True,
                             prefix_p=32)[0]
    check_paged(f"{tag} staged and prefix_p", got,
                [ref.expect(q, "and") for q in hits], 32)
    if lookups:
        look = [[q[0] for q in b] for b in stream]
        got = _timed_stream("lookup_staged", lambda: eng.lookup_staged(
            [[ref.term(i) for i in b] for b in look], columnar=True), nq, card)
        for b, g in zip(look, got):
            check_columnar(f"{tag} lookup_staged", g, [ref.get(i) for i in b])
        lk = look[0][: max(1, Q // 8)]
        check_rows(f"{tag} lookup", eng.lookup([ref.term(i) for i in lk]),
                   [ref.get(i) for i in lk])
    if oneshot:
        for size in (256, Q):  # below and above the staged-delegation size
            qs = stream[0][:size]
            for op in ("and", "or"):
                got, dt = timed(lambda: eng.boolean(to_terms(ref, qs), op))
                check_rows(f"{tag} boolean {op} x{size}", got,
                           [ref.expect(q, op) for q in qs])
            log(f"    one-shot boolean x{len(qs)}: AND/OR equal the reference")
        prefixes = [ref.term(int(i))[: int(k)] for i, k in zip(
            rng.integers(0, n, 200), rng.integers(3, 6, 200))] + [b"\x01"]
        got, dt = timed(lambda: eng.prefix_search(prefixes))
        check_prefix(f"{tag} prefix_search", got, ref, prefixes)
        log(f"    prefix_search: {len(prefixes)} prefixes in {dt:.3f} s")
    log(f"[{tag}] every op equals the reference ({nq} stream queries per op); "
        + memory_line(jax.devices()[:1]))
    return eng


def phase_serving(card: str, n_terms: int = 10_000_000, mean_len: int = 10,
                  nb: int = 4, Q: int = 8192, L: int = 128, seed: int = 29):
    """Config-5 scale: 10M terms x mean posting length 10 (~100M postings)."""
    import bench

    corpus, gen_s = timed(lambda: bench.gen_corpus(n_terms, mean_len, seed=seed))
    log(f"[phase 2] gen_corpus({n_terms}, {mean_len}) in {gen_s:.2f} s")
    return serve_corpus("phase 2", corpus, L, nb, Q, seed, card)


def phase_postlen1k(card: str, n_terms: int = 200_000, mean_len: int = 1000,
                    nb: int = 3, Q: int = 8192, L: int = 2048, seed: int = 11):
    """Config-3 shape: mean posting length 1k, 2-8 terms per query."""
    import bench

    corpus, gen_s = timed(lambda: bench.gen_corpus(n_terms, mean_len, seed=seed))
    log(f"[phase 3] gen_corpus({n_terms}, {mean_len}) in {gen_s:.2f} s")
    return serve_corpus("phase 3", corpus, L, nb, Q, seed, card,
                        oneshot=False, lookups=False)


# ---------------------------------------------------------------------------
# --mesh N: sharded serving
# ---------------------------------------------------------------------------


def _hash_routed_vocab(n: int, rng, n_shards: int = 64) -> np.ndarray:
    """12-byte terms whose 2-byte prefix (the shard key's source) is picked
    by a hash of the rest of the term: hash-routed over `n_shards` shard
    keys (shard key = first two bytes >> 6)."""
    raw = rng.integers(97, 123, size=(n, 12), dtype=np.uint8)
    h = (raw[:, 2:].astype(np.uint64) * np.uint64(0x9E3779B1)).sum(axis=1)
    slot = (h % np.uint64(n_shards)).astype(np.int64)
    raw[:, 0] = 97 + slot // 4
    raw[:, 1] = 1 + 64 * (slot % 4)
    return np.unique(raw.view("S12").ravel())


def phase_mesh(basedir: str, n_devices: int, card: str, vocab: int = 1_000_000,
               n_occ: int = 2_000_000, batch: int = 250_000, doc_terms: int = 50,
               n_queries: int = 2048, seed: int = 41):
    """Config-4 shape on `n_devices` devices: MeshQueryEngine vs a
    single-device QueryEngine vs the numpy reference, bit for bit."""
    import jax

    from inverted_index_2_tpu import InvertedIndex
    from inverted_index_2_tpu.models.query_engine import QueryEngine
    from inverted_index_2_tpu.parallel import MeshQueryEngine
    from inverted_index_2_tpu.parallel.mesh import default_mesh

    rng = np.random.default_rng(seed)
    voc = _hash_routed_vocab(vocab, rng)
    voc_list = [bytes(t) for t in voc]
    ii = InvertedIndex(basedir)
    occ_t, occ_v = [], []
    value = 1
    t0 = time.monotonic()
    for s in range(0, n_occ, batch):
        idx = rng.integers(0, len(voc), size=min(batch, n_occ - s))
        nxt = _put_docs(ii, voc_list, idx, doc_terms, value)
        occ_t.append(idx)
        occ_v.append(value + np.arange(len(idx)) // doc_terms)
        value = nxt
    n_shards = len(ii._snapshot())
    removed = np.sort(rng.choice(np.arange(1, value), size=max(1, (value - 1) // 100),
                                 replace=False)).astype(np.uint32)
    ii.put_removed(removed)
    log(f"[mesh] ingest: {n_occ} occurrences into {n_shards} shards in "
        f"{time.monotonic() - t0:.2f} s")
    # reads never apply tombstones (nothing is merged here)
    key = np.unique(np.concatenate(occ_t).astype(np.int64) * (1 << 32)
                    + np.concatenate(occ_v))
    term_of, val = key >> 32, (key & 0xFFFFFFFF).astype(np.uint32)
    present, starts = np.unique(term_of, return_index=True)
    ref = Lists(voc[present], val, np.append(starts, len(val)).astype(np.int64))
    n = len(ref)

    mesh = default_mesh(n_devices)
    (meng, build_s) = timed(lambda: MeshQueryEngine(ii, mesh=mesh, L=128,
                                                    q_bucket=n_queries))
    blocks_devs = meng.snap.blocks.sharding.device_set
    if len(blocks_devs) != n_devices:
        raise AssertionError(f"snap.blocks spans {len(blocks_devs)} devices")
    shard_bytes = {s.device.id: s.data.nbytes for s in meng.snap.blocks.addressable_shards}
    if len(shard_bytes) != n_devices or min(shard_bytes.values()) <= 0:
        raise AssertionError(f"per-device arena shards: {shard_bytes}")
    in_use = {d.id: (d.memory_stats() or {}).get("bytes_in_use") for d in mesh.devices.flat}
    if any(v is not None and v <= 0 for v in in_use.values()):
        raise AssertionError(f"a device holds no bytes: {in_use}")
    log(f"[mesh] MeshQueryEngine over {n_devices} devices built in {build_s:.2f} s; "
        f"arena shard bytes per device {shard_bytes}; bytes_in_use {in_use}")
    eng = QueryEngine.from_index(ii, L=128, q_bucket=n_queries)

    look = rng.integers(0, n, size=n_queries)
    lt = [ref.term(i) for i in look]
    want = [ref.get(i) for i in look]
    a, b = meng.lookup(lt), eng.lookup(lt)
    check_rows("mesh lookup", a, want)
    check_rows("single-device lookup", b, want)
    qs = query_stream(n, 1, n_queries // 2, seed)[0] + hit_queries(n, n_queries // 2, seed)
    tq = to_terms(ref, qs)
    for op in ("and", "or"):
        want = [ref.expect(q, op) for q in qs]
        got, dt = timed(lambda: meng.boolean(tq, op))
        check_rows(f"mesh boolean {op}", got, want)
        check_rows(f"single-device boolean {op}", eng.boolean(tq, op), want)
        log(f"    mesh boolean {op}: {len(qs)} queries in {dt:.3f} s ({card})")
        want_f = [ref.expect(q, op, removed) for q in qs]
        check_rows(f"mesh boolean {op} filter_removed",
                   meng.boolean(tq, op, filter_removed=True), want_f)
    want = [ref.expect(q, "or") for q in qs]
    for name, e in (("mesh", meng), ("single-device", eng)):
        got = e.boolean_staged([tq], "or", columnar=True, prefix_p=32)[0]
        check_paged(f"{name} boolean_staged prefix_p", got, want, 32)
    prefixes = [ref.term(int(i))[: int(k)] for i, k in zip(
        rng.integers(0, n, 200), rng.integers(3, 6, 200))] + [b"\x01"]
    check_prefix("mesh prefix_search", meng.prefix_search(prefixes), ref, prefixes)
    check_prefix("single-device prefix_search", eng.prefix_search(prefixes), ref,
                 prefixes)
    lo, hi = sorted(rng.integers(0, n, size=2))
    want_terms = [ref.term(i) for i in range(lo, hi + 1)]
    want_vals = [ref.get(i) for i in range(lo, hi + 1)]
    for name, e in (("mesh", meng), ("single-device", eng)):
        got = list(e.read_range(ref.term(lo), ref.term(hi)))
        if [t for t, _ in got] != want_terms:
            raise AssertionError(f"{name} read_range: terms differ")
        check_rows(f"{name} read_range", [v for _, v in got], want_vals)
    log(f"[mesh] lookup, AND, OR, prefix_search, boolean_staged prefix_p=32 and "
        f"read_range ({hi - lo + 1} terms) equal the single-device engine and the "
        "reference; " + memory_line(mesh.devices.flat))


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", type=int, default=0,
                    help="run only the sharded phase, over this many GPUs")
    args = ap.parse_args(argv)

    import jax

    import inverted_index_2_tpu
    from inverted_index_2_tpu.codec import native
    from inverted_index_2_tpu.utils.compile_cache import enable_compile_cache

    pkg = os.path.dirname(os.path.abspath(inverted_index_2_tpu.__file__))
    if os.path.dirname(pkg) != _HERE:
        print(f"chip_smoke: the package at {pkg} is not this checkout's",
              file=sys.stderr)
        return 2
    cache = enable_compile_cache()
    info = phase_device()
    if info["platform"] != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {info['platform']!r})",
              file=sys.stderr)
        return 2
    if not native.available():
        print("chip_smoke: the native codec did not load", file=sys.stderr)
        return 2
    card = card_line()
    log(f"card (nvidia-smi name, power.limit): {card}")
    log(f"compile cache: {cache}")
    card = card.splitlines()[0]
    t_all = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.mesh:
            if len(jax.devices()) < args.mesh:
                print(f"chip_smoke: --mesh {args.mesh} needs {args.mesh} GPUs, "
                      f"found {len(jax.devices())}", file=sys.stderr)
                return 2
            _, dt = timed(lambda: phase_mesh(os.path.join(tmp, "mesh"), args.mesh,
                                             card))
            log(f"[mesh] passed in {dt:.1f} s")
        else:
            (ii, ref), dt = timed(lambda: phase_write_path(os.path.join(tmp, "idx")))
            log(f"[phase 1] passed in {dt:.1f} s")
            _, dt = timed(lambda: serve_from_index(ii, ref))
            del ii, ref
            eng, dt2 = timed(lambda: phase_serving(card))
            del eng
            log(f"[phase 2] passed in {dt + dt2:.1f} s")
            eng, dt = timed(lambda: phase_postlen1k(card))
            del eng
            log(f"[phase 3] passed in {dt:.1f} s")
    log(f"all phases passed in {time.monotonic() - t_all:.1f} s; "
        + memory_line(jax.devices()[: max(1, args.mesh)]))
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
