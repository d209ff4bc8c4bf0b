"""Refresh-vs-serve race storm: readers hammer the serving paths WHILE a
writer loops put / put_removed / merge / refresh — the atomic ServingState
swap contract.

The invariant under test is the reference's copy-on-read snapshot protocol
(/root/reference/segments.go:25-53, inverted_index.go shard-list copies):
a query must run against ONE consistent published state. Concretely:

 * NO RESURRECTION: once a refresh that hides a value (tombstone publish)
   or purges it (merge + full rebuild) has RETURNED, no later
   filter_removed read may ever report that value again. Before the
   single-assignment ServingState swap, a reader could pair an OLD main
   (value still present) with a NEW tombstone array (value already purged
   from it by merge, so no longer listed) and let the value through.
 * NO TORN PAIRING / NO LOST TIERS: values published by a completed
   refresh (main or delta tier) must all be visible — a reader pairing a
   new main with a stale delta would drop or duplicate a tier.
 * NO CRASHES: a half-swapped state can also surface as width/shape
   mismatches deep in the dispatch; every reader exception is collected
   and re-raised.

Unlike the quiesced refresh tests in test_query_engine.py, readers here
never synchronize with the writer.
"""
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from inverted_index_2_tpu import InvertedIndex
from inverted_index_2_tpu.models.query_engine import QueryEngine
from inverted_index_2_tpu.parallel import MeshQueryEngine
from inverted_index_2_tpu.parallel import mesh as pm

VICTIM = b"victim"
GROW = b"grow"
BASE_TERMS = [f"base{i:02d}".encode() for i in range(12)]


def _seed_index(tmp_path):
    ii = InvertedIndex(str(tmp_path))
    for doc in range(1, 13):
        ii.put([BASE_TERMS[doc % len(BASE_TERMS)], GROW, VICTIM], doc)
    return ii


class _Storm:
    """Shared writer/reader scaffolding for both engines."""

    def __init__(self, ii, engine, refresh):
        self.ii = ii
        self.engine = engine
        self.refresh = refresh  # callable(ii) -> None, engine-specific
        self.lock = threading.Lock()
        self.banned = set()       # hidden-or-purged doc ids, published
        self.grow_published = set(range(1, 13))
        self.done = threading.Event()
        self.errors = []

    # -- writer ------------------------------------------------------------

    def writer(self, rounds):
        try:
            for r in range(rounds):
                vdoc, gdoc = 10_000 + r, 20_000 + r
                # additive change -> delta-path refresh (tombstones are
                # doc-level, so the victim doc must NOT carry GROW — its
                # removal below would hide it from GROW too)
                self.ii.put([VICTIM, b"extra%d" % r], vdoc)
                self.ii.put([GROW], gdoc)
                self.refresh(self.ii)
                with self.lock:
                    self.grow_published.add(gdoc)
                # hide the victim doc behind a tombstone
                self.ii.put_removed([vdoc])
                self.refresh(self.ii)
                with self.lock:
                    self.banned.add(vdoc)
                # purge it for real: merge-until-zero, then a refresh that
                # must take the full-rebuild path (segments vanished) —
                # afterwards the tombstone array shrinks while the doc is
                # gone from the segments (the resurrection window)
                while self.ii.merge(1, 1_000, 2) > 0:
                    pass
                self.refresh(self.ii)
        except BaseException as e:  # surfaced by the main thread
            self.errors.append(e)
        finally:
            self.done.set()

    # -- readers -----------------------------------------------------------

    def check_rows(self, banned, expect_grow, victim_rows, grow_rows):
        got_v = set() if victim_rows is None else set(
            np.asarray(victim_rows).tolist()
        )
        resurrected = got_v & banned
        assert not resurrected, (
            f"purged/hidden values resurrected: {sorted(resurrected)}"
        )
        got_g = set() if grow_rows is None else set(
            np.asarray(grow_rows).tolist()
        )
        missing = expect_grow - got_g
        assert not missing, f"published values lost: {sorted(missing)[:8]}"

    def reader(self, serve):
        """serve() -> (victim_values | None, grow_values | None)."""
        try:
            while not self.done.is_set():
                with self.lock:
                    banned = set(self.banned)
                    expect_grow = set(self.grow_published)
                victim_rows, grow_rows = serve()
                self.check_rows(banned, expect_grow, victim_rows, grow_rows)
        except BaseException as e:
            self.errors.append(e)

    def run(self, rounds, serves):
        threads = [threading.Thread(target=self.reader, args=(s,))
                   for s in serves]
        w = threading.Thread(target=self.writer, args=(rounds,))
        for t in threads:
            t.start()
        w.start()
        w.join()
        for t in threads:
            t.join()
        if self.errors:
            raise self.errors[0]


def test_refresh_vs_serve_storm_query_engine(tmp_path):
    ii = _seed_index(tmp_path)
    eng = QueryEngine.from_index(ii, L=128, q_bucket=8)

    def serve_lookup():
        rows = eng.lookup([VICTIM, GROW], filter_removed=True)
        return rows[0], rows[1]

    def serve_boolean():
        v = eng.boolean([[VICTIM]], "or", filter_removed=True)[0]
        g = eng.boolean([[GROW, GROW]], "and", filter_removed=True)[0]
        return v, g

    def serve_staged():
        out = eng.boolean_staged(
            [[[VICTIM]], [[GROW]]], "or", filter_removed=True
        )
        return out[0][0], out[1][0]

    _Storm(ii, eng, lambda idx: eng.refresh(idx)).run(
        rounds=5, serves=[serve_lookup, serve_boolean, serve_staged]
    )
    # post-storm ground truth: every victim doc purged, grow intact
    final_v, final_g = (set(np.asarray(r).tolist()) for r in eng.lookup(
        [VICTIM, GROW], filter_removed=True
    ))
    assert not (final_v & {10_000 + r for r in range(5)})
    assert {20_000 + r for r in range(5)} <= final_g


def test_refresh_vs_serve_storm_mesh_engine(tmp_path):
    if len(jax.devices()) < 4:
        pytest.skip("needs multiple virtual devices")
    ii = _seed_index(tmp_path)
    eng = MeshQueryEngine(ii, mesh=pm.default_mesh(4), L=128, q_bucket=8)

    def serve_lookup():
        rows = eng.lookup([VICTIM, GROW], filter_removed=True)
        return rows[0], rows[1]

    def serve_boolean():
        v = eng.boolean([[VICTIM]], "or", filter_removed=True)[0]
        g = eng.boolean([[GROW]], "and", filter_removed=True)[0]
        return v, g

    _Storm(ii, eng, lambda idx: eng.refresh(idx)).run(
        rounds=3, serves=[serve_lookup, serve_boolean]
    )
    final_v = eng.lookup([VICTIM], filter_removed=True)[0]
    got = set() if final_v is None else set(np.asarray(final_v).tolist())
    assert not (got & {10_000 + r for r in range(3)})
