"""Sharded differential oracle: mixed merge regimes, exact tombstone
retention.

The original differential test (test_differential.py) keeps every shard at
>= 2 segments so purge semantics stay uniform. This oracle models the
reference's ACTUAL per-shard behavior (shard.go:127-245):

 * one direct segment per (put x touched shard); shard key = first 10 bits
   of the first two term bytes, short terms -> shard 0 (shard.go:362-378)
 * merge(req, m): a shard with fewer than `req` segments SKIPS compaction
   and RETAINS its tombstones (shard.go:130, :149); merged shards purge the
   union of their live tombstone batches; all-purged output writes nothing
 * remove(): GC's batches older than every live segment and now
   (shard.go:84-98), then appends a new batch
 * reads never apply tombstones

so random workloads can leave shards in NON-uniform states (1-segment
shards that keep tombstones, empty shards, shards that skipped a round) and
still be verified exactly — including the merge RETURN COUNTS.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from inverted_index_2_tpu import InvertedIndex, to_slice
from inverted_index_2_tpu.models.query_engine import QueryEngine


def shard_of(term: bytes) -> int:
    if len(term) < 2:
        return 0
    return ((term[0] << 8) | term[1]) >> 6


class ShardOracle:
    def __init__(self):
        self.clock = 0
        self.shards = {}  # sid -> {"segs": [(ts, {term: set(vals)})], "batches": [(ts, set)]}

    def _tick(self):
        self.clock += 1
        return self.clock

    def _shard(self, sid):
        return self.shards.setdefault(sid, {"segs": [], "batches": []})

    def put(self, terms, value):
        groups = {}
        for t in set(terms):
            groups.setdefault(shard_of(t), {})[t] = {value}
        for sid, seg in groups.items():
            self._shard(sid)["segs"].append((self._tick(), seg))

    def put_removed(self, values):
        vals = set(values)
        for sid, sh in self.shards.items():
            now = self._tick()
            live = [ts for ts, _ in sh["segs"]]
            floor = min(live + [now])
            sh["batches"] = [(ts, b) for ts, b in sh["batches"] if ts >= floor]
            sh["batches"].append((now, vals))

    def merge(self, req_count: int) -> int:
        """merge(req, m=all) across shards; returns input segments consumed."""
        total = 0
        for sid, sh in self.shards.items():
            if len(sh["segs"]) < max(2, req_count):
                continue
            claimed = sh["segs"]
            total += len(claimed)
            tomb = set().union(*[b for _, b in sh["batches"]]) if sh["batches"] else set()
            merged = {}
            for _, seg in claimed:
                for t, vs in seg.items():
                    merged.setdefault(t, set()).update(vs)
            merged = {t: vs - tomb for t, vs in merged.items()}
            merged = {t: vs for t, vs in merged.items() if vs}
            sh["segs"] = [(self._tick(), merged)] if merged else []
            # tombstone batches are NOT cleared by merge (reference parity)
        return total

    def dump(self):
        out = {}
        for sh in self.shards.values():
            for _, seg in sh["segs"]:
                for t, vs in seg.items():
                    out.setdefault(t, set()).update(vs)
        return out


def dump(ii):
    return {tv.term: set(tv.values.tolist()) for tv in to_slice(ii.read(None, None))}


@pytest.mark.parametrize("seed", [7, 0xBEEF, 20260816])
def test_mixed_regime_random_workload(tmp_path, seed):
    rng = np.random.default_rng(seed)
    ii = InvertedIndex(str(tmp_path))
    oracle = ShardOracle()
    # vocabulary spanning many shards, including short (<2 byte) terms that
    # route to shard 0 regardless of bytes
    vocab = [
        bytes(rng.integers(97, 123, size=int(rng.integers(1, 9)), dtype=np.uint8))
        for _ in range(50)
    ] + [b"a", b"z", b""]
    vocab = sorted(set(v for v in vocab if v != b""))
    value = 0
    for round_ in range(8):
        # UNEVEN puts: some shards end up with 1 segment, some with many,
        # some untouched this round
        for _ in range(int(rng.integers(1, 6))):
            value += 1
            k = int(rng.integers(1, 7))
            terms = [vocab[i] for i in rng.choice(len(vocab), size=k, replace=False)]
            ii.put(terms, value)
            oracle.put(terms, value)
        assert dump(ii) == oracle.dump(), f"round {round_} post-put"

        if rng.random() < 0.7 and value:
            doomed = (rng.choice(value, size=min(4, value), replace=False) + 1).tolist()
            ii.put_removed(doomed)
            oracle.put_removed(doomed)
            assert dump(ii) == oracle.dump(), f"round {round_} post-remove"

        # random merge regime: req varies, so some shards skip and RETAIN
        # tombstones; assert the exact consumed count each pass
        req = int(rng.integers(2, 5))
        while True:
            want = oracle.merge(req)
            got = ii.merge(req, 100, 3)
            assert got == want, f"round {round_} merge count (req={req})"
            if got == 0:
                break
        assert dump(ii) == oracle.dump(), f"round {round_} post-merge"

        if round_ % 3 == 2:
            ii = InvertedIndex(str(tmp_path))
            assert dump(ii) == oracle.dump(), f"round {round_} reopen"

    # device engine agreement on the final mixed state
    data = oracle.dump()
    eng = QueryEngine.from_index(ii, L=256)
    got = eng.lookup(sorted(data.keys()))
    for t, g in zip(sorted(data.keys()), got):
        assert g is not None and set(g.tolist()) == data[t], t


def _oracle_put_many(oracle, docs):
    """put_many's observable grouping: ONE segment per touched shard for
    the whole batch (values may differ per term)."""
    groups = {}
    for terms, value in docs:
        for t in set(terms):
            groups.setdefault(shard_of(t), {}).setdefault(t, set()).add(value)
    for sid, seg in groups.items():
        oracle._shard(sid)["segs"].append((oracle._tick(), seg))


HOSTILE_VOCAB = [
    b"\x00", b"\x00\x00", b"\x00aaa", b"a\x00b", b"a\x00", b"\x00\xff",
    b"\xff", b"\xff\xff", b"\xff\xff\xffzz", b"\xfe\xff\xff\xff",
    b"a", b"z", b"\x7f",                      # 1-byte terms
    b"abcd", b"abcdefgh", b"abcdefghijkl",    # word-boundary lengths
    b"abc", b"abcde", b"abcdefghi",           # straddling word boundaries
    b"ban", b"band", b"banjo", b"bandana",    # shared prefixes
    b"ba", b"b",
    b"q" * 33, b"q" * 32, b"q" * 31,          # long terms at boundaries
]


@pytest.mark.parametrize("seed", [3, 0xC0FFEE, 20260817])
def test_hostile_terms_differential(tmp_path, seed):
    """Adversarial differential pass at the index API:
    hostile terms (embedded NULs, 0xFF runs, 1-byte terms, word-boundary
    lengths, shared prefixes) driven through put/put_many/put_removed/
    merge/prefix_search/read_bulk AND the QueryEngine (device concat path
    and host serve) against the dict-of-sets oracle."""
    import os

    rng = np.random.default_rng(seed)
    ii = InvertedIndex(str(tmp_path))
    oracle = ShardOracle()
    vocab = HOSTILE_VOCAB
    value = 0
    for round_ in range(6):
        for _ in range(int(rng.integers(1, 5))):
            value += 1
            k = int(rng.integers(1, 7))
            terms = [vocab[i] for i in rng.choice(len(vocab), size=k, replace=False)]
            ii.put(terms, value)
            oracle.put(terms, value)
        # batched multi-doc ingest every other round
        if round_ % 2 == 1:
            docs = []
            for _ in range(3):
                value += 1
                k = int(rng.integers(1, 5))
                docs.append(([vocab[i] for i in rng.choice(len(vocab), size=k, replace=False)], value))
            ii.put_many(docs)
            _oracle_put_many(oracle, docs)
        assert dump(ii) == oracle.dump(), f"round {round_} post-put"

        if rng.random() < 0.7 and value:
            doomed = (rng.choice(value, size=min(4, value), replace=False) + 1).tolist()
            ii.put_removed(doomed)
            oracle.put_removed(doomed)

        req = int(rng.integers(2, 5))
        while True:
            want = oracle.merge(req)
            got = ii.merge(req, 100, 3)
            assert got == want, f"round {round_} merge count (req={req})"
            if got == 0:
                break
        assert dump(ii) == oracle.dump(), f"round {round_} post-merge"

    data = oracle.dump()
    # prefix_search differential, hostile prefixes included
    prefixes = [b"\x00", b"\xff", b"ban", b"band", b"b", b"a", b"q" * 31,
                b"abcd", b"zzz-none"]
    got_pf = ii.prefix_search(prefixes)
    for p in prefixes:
        want = set().union(*[vs for t, vs in data.items() if t.startswith(p)]) \
            if any(t.startswith(p) for t in data) else None
        if want is None:
            assert p not in got_pf, p
        else:
            assert set(got_pf[p].tolist()) == want, p

    # read_bulk differential over hostile bounds
    for lo, hi in [(None, None), (b"\x00", b"\xff"), (b"a", b"band"),
                   (b"ban", b"q" * 33), (b"\xff", None)]:
        rb = ii.read_bulk(lo, hi)
        want_terms = sorted(
            t for t in data
            if (lo is None or t >= lo) and (hi is None or t <= hi)
        )
        if rb is None:
            assert not want_terms, (lo, hi)
        else:
            blob, offs, vals, voffs = rb
            terms_got = [bytes(blob[offs[i]:offs[i + 1]]) for i in range(len(offs) - 1)]
            assert terms_got == want_terms, (lo, hi)
            for i, t in enumerate(terms_got):
                assert set(vals[voffs[i]:voffs[i + 1]].tolist()) == data[t], t

    # QueryEngine: lookup + boolean through the device concat path
    from inverted_index_2_tpu.models.query_engine import snapshot_index
    eng = QueryEngine(snapshot_index(ii), L=256, q_bucket=8)
    terms_all = sorted(data.keys())
    got = eng.lookup(terms_all)
    for t, g in zip(terms_all, got):
        assert g is not None and set(g.tolist()) == data[t], t
    if len(terms_all) >= 3:
        qs = []
        for _ in range(9):
            k = int(rng.integers(2, 4))
            qs.append([terms_all[i] for i in rng.choice(len(terms_all), size=k, replace=False)])
        for op in ("and", "or"):
            res = eng.boolean(qs, op)
            for q, g in zip(qs, res):
                sets = [data[t] for t in q]
                want = set.intersection(*sets) if op == "and" else set.union(*sets)
                assert set(g.tolist()) == want, (op, q)
            # the pipelined concat-class stream must serve hostile
            # terms identically
            staged = eng.boolean_staged([qs[:5], qs[5:]], op)
            for q, g in zip(qs, staged[0] + staged[1]):
                sets = [data[t] for t in q]
                want = set.intersection(*sets) if op == "and" else set.union(*sets)
                assert set(g.tolist()) == want, ("staged", op, q)
    # host serving routes against the same oracle: hostile terms driven
    # through pack_blob -> hash probe -> the fused native serve
    # (tpi_boolean_serve) and the host lookup decode
    heng = QueryEngine.from_index(ii, L=256, q_bucket=8)
    if heng.host_ready() and data:
        terms_all = sorted(data.keys())
        for t, g in zip(terms_all, heng.lookup_host(terms_all)):
            assert g is not None and g.tolist() == sorted(data[t]), t
        assert heng.lookup_host([b"definitely-not-a-term"]) == [None]
        qs2 = [
            [terms_all[i] for i in rng.choice(
                len(terms_all), size=int(rng.integers(1, 4)),
                replace=False)]
            for _ in range(8)
        ] + [[b"not-a-term", terms_all[0]], []]
        for op in ("and", "or"):
            res = heng.boolean_host(qs2, op)
            for q, g in zip(qs2, res):
                sets = [data.get(t) for t in q]
                if op == "and":
                    want = (set() if not sets or any(s is None for s in sets)
                            else set.intersection(*sets))
                else:
                    present = [s for s in sets if s is not None]
                    want = set().union(*present) if present else set()
                assert g.tolist() == sorted(want), ("host", op, q)
        # pinned DEVICE pagination with hostile terms: host-side
        # resolve (native tpi_hash_probe) -> concat classes ->
        # scatter-coalesced harvest -> u16 delta plane, both wire modes
        os.environ["TPI_HOST_BOOL"] = "0"
        try:
            qs3 = [q for q in qs2 if q]
            present = [
                sorted(set().union(*[data.get(t, set()) for t in q]))
                for q in qs3
            ]
            for wire in ("1", "0"):
                os.environ["TPI_WIRE"] = wire
                for Pp in (2, 8):
                    vals, voffs, counts = heng.boolean_staged(
                        [qs3], "or", columnar=True, prefix_p=Pp)[0]
                    for i, w in enumerate(present):
                        assert counts[i] == len(w), ("page", wire, Pp, i)
                        assert vals[voffs[i]:voffs[i + 1]].tolist() \
                            == w[:Pp], ("page", wire, Pp, i)
        finally:
            os.environ.pop("TPI_HOST_BOOL", None)
            os.environ.pop("TPI_WIRE", None)
