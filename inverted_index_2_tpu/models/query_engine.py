"""Device-resident query engine — the flagship "model" of this framework.

The reference serves queries by opening files and walking iterators per call
(/root/reference/inverted_index.go:300, shard.go:72). The device serves
queries as batched array programs over an immutable DEVICE SNAPSHOT of the
index:

    IndexSnapshot ("parameters"):
        keys              (N, W+1)     uint32  global sorted term dictionary
        blocks            (B, stride)  uint32  posting-block row arena
                                               (byte-aligned codec blocks,
                                               one row per block: whole-row
                                               gathers of contiguous rows)
        term_block_start  (N+1,)       int32   first block row of each term
        counts            (N,)         int32   postings per term
        hash_slots        (S,)         int32   linear-probe exact-lookup table
        removed           (R,)         uint32  sorted tombstones (optional)

    QueryEngine ("forward passes"), all jit-compiled, static shapes:
        lookup:   Q terms -> (found, postings (Q, L), counts, raw counts)
        AND/OR:   Q x K terms -> combined posting sets (+ per-query `need`)
        prefix:   device range search + device decode + vectorized union

    Long posting lists are EXACT: rows whose true count exceeds the fast-path
    L are re-served at the smallest ladder level (L, 4L, 16L, ... capped at
    the corpus' longest list) that fits — everything decodes on device; the
    snapshot keeps NO host mirror of terms or postings.

Snapshot semantics match a reference Read(nil, nil) over the whole index
(union across segments, NO tombstone filtering — tombstones act at merge,
see inverted_index_test.go:59-82 flow); pass apply_removed=True to purge at
build, or filter_removed=True per query batch for the vectorized-tombstone
query path (north star: "removed_list.go's tombstones applied as vectorized
bitmask filters").
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import itertools as it
import math
import os
import threading

import numpy as np

import jax
import jax.numpy as jnp

from ..codec import keys as keys_mod
from ..codec import native as _native  # noqa: F401  (tests patch via here)
from ..ops import dict_search as ds
from ..shard import merge_views

# The engine is split across sibling modules; EVERY name is re-exported
# here so `models.query_engine` stays the single import surface (bench,
# tests, parallel/*, checkpoint all resolve through it).
from .snapshot import (  # noqa: F401
    HostTables,
    IndexSnapshot,
    _SnapshotTier,
    _collect_removed,
    _empty_snapshot,
    _empty_tables,
    _empty_snapshot_host,
    _expand_arena,
    _expand_arena_step,
    _index_fingerprint,
    _purge_merged,
    build_host_tables,
    build_snapshot_arrays,
    snapshot_index,
    snapshot_new_segments,
    snapshot_tables,
    upload_tables,
)
from .steps import (  # noqa: F401
    _JIT_BOOLEAN,
    _JIT_BOOLEAN_DUAL,
    _JIT_CONCAT_BOOL,
    _JIT_CONCAT_BOOL_SEL,
    _JIT_DECODE,
    _JIT_FILTER,
    _JIT_LOOKUP,
    _JIT_PREFIX,
    _JIT_RESOLVE,
    _JIT_WIRE_META,
    _JIT_WIRE_PACK,
    _RESERVE_BUDGET,
    _batch_as_lists,
    _ladder,
    _narrow_keys,
    _resolve,
    _rows_to_columnar,
    _round_up,
    _wire_meta_step,
    _wire_pack_step,
    _JIT_RESOLVE_SB,
    _dedup_adjacent,
    _wire_unpack,
    boolean_step,
    boolean_step_dual,
    lookup_step,
    prefix_range_step,
)
from .host_serve import HostServingMixin
from .staged import StagedStreamsMixin




_LINK_MBPS: Optional[float] = None


def _link_mbps() -> float:
    """Measured host<->device link bandwidth (MB/s, round-trip corrected),
    probed once per process: device_put + device_get of a FRESH 4 MB and a
    FRESH 4 KB array per rep (pure transfers, no jit programs to compile),
    latency-corrected by the small probe, best-of-2. The array MUST be
    fresh each rep: once an array has been device_get once, its host copy
    is cached and later gets return in ~0, so a reused-array probe would
    read an absurd bandwidth. Drives transport-aware serving routes
    (_host_boolean_route); TPI_LINK_MBPS pins it for tests/ops."""
    global _LINK_MBPS
    if _LINK_MBPS is None:
        pinned = os.environ.get("TPI_LINK_MBPS")
        if pinned is not None:
            _LINK_MBPS = float(pinned)
            return _LINK_MBPS
        import time as _time

        def best(nwords):
            t = math.inf
            for _ in range(2):
                arr = np.zeros(nwords, dtype=np.uint32)
                t0 = _time.monotonic()
                jax.device_get(jax.device_put(arr))
                t = min(t, _time.monotonic() - t0)
            return t

        nbytes = (1 << 22) - (1 << 12)
        dt = max(best(1 << 20) - best(1 << 10), 1e-6)
        # bytes cross the link twice (up on the put, down on the get)
        _LINK_MBPS = 2 * nbytes / dt / 2**20
    return _LINK_MBPS




class ServingState:
    """One immutable bundle of everything a serve path reads: the snapshot
    tier pair, the tombstone arrays, the retained host tables, and the
    freeze fingerprints. refresh() publishes a complete new bundle with a
    SINGLE reference assignment (atomic under the GIL), and every serve
    entry point captures one local reference up front — a concurrent
    reader therefore sees either the whole old state or the whole new one,
    never a new main paired with a stale delta or stale tombstones (the
    reference's copy-on-read snapshot protocol, segments.go:25-53 +
    inverted_index.go's shard-list copies)."""

    __slots__ = ("snap", "delta", "removed", "tables", "delta_tables",
                 "fingerprint", "main_fp", "_removed_host", "device_ready")

    def __init__(self, snap: IndexSnapshot,
                 delta: Optional[IndexSnapshot] = None,
                 removed=None,
                 tables: Optional[HostTables] = None,
                 delta_tables: Optional[HostTables] = None,
                 fingerprint=None, main_fp=None,
                 removed_host: Optional[np.ndarray] = None,
                 device_ready: bool = True):
        self.snap = snap
        self.delta = delta
        self.removed = removed
        self.tables = tables
        self.delta_tables = delta_tables
        self.fingerprint = fingerprint
        self.main_fp = main_fp
        self._removed_host = removed_host
        # False only during a warm checkpoint start: the snapshot is an
        # EMPTY placeholder while the real arena uploads in the background,
        # and every serve path routes through the retained host tables
        # (from_checkpoint publishes the full-device state when the upload
        # lands). Serve paths must consult this BEFORE any device route.
        self.device_ready = device_ready

    def replace(self, **kw) -> "ServingState":
        """A copy with the given fields replaced (the rest shared)."""
        args = {
            "delta": self.delta, "removed": self.removed,
            "tables": self.tables, "delta_tables": self.delta_tables,
            "fingerprint": self.fingerprint, "main_fp": self.main_fp,
            "removed_host": self._removed_host,
            "device_ready": self.device_ready,
        }
        snap = kw.pop("snap", self.snap)
        args.update(kw)
        return ServingState(snap, **args)

    def removed_host(self) -> Optional[np.ndarray]:
        """Host mirror of the serving tombstone array (lazy; idempotent —
        racing computations produce the same value)."""
        rh = self._removed_host
        if rh is None and self.removed is not None:
            rh = np.asarray(self.removed)
            self._removed_host = rh
        return rh

    def host_ready(self) -> bool:
        """Host-side serving covers this state's tier pair."""
        return self.tables is not None and (
            self.delta is None or self.delta_tables is not None
        )

    def max_count(self) -> int:
        m = self.snap.max_count
        if self.delta is not None:
            m += self.delta.max_count  # a term's tier union can reach the sum
        return m

    def width(self) -> int:
        """Query key width across the live tier pair (device snapshots)."""
        w = self.snap.width
        if self.delta is not None:
            w = max(w, self.delta.width)
        return w

    def host_q_width(self) -> int:
        w = self.tables.width
        if self.delta_tables is not None:
            w = max(w, self.delta_tables.width)
        return w


class QueryEngine(HostServingMixin, StagedStreamsMixin):
    """Batched query serving over a frozen IndexSnapshot.

    Q is padded to buckets so jit caches stay small. L (posting pad length)
    is the FAST-PATH pad: queries whose posting lists exceed L are re-served
    exactly on device at the smallest ladder level that fits (L, 4L, 16L, ...
    up to the corpus' longest list) — results are always exact, with no host
    mirror of the postings (the reference streams any-length runs,
    reader.go:79-98; here exactness costs a second pass for the rare long
    queries instead of memory for all of them).
    """

    # delta promotion threshold: a delta larger than this fraction of main
    # triggers a full rebuild (the LSM analogue of compaction)
    DELTA_FRACTION = 0.25

    # one-shot boolean() batches at least this large delegate to the staged
    # stream when the device route is chosen (see boolean()); below it the
    # single-dispatch path's latency is the whole cost either way
    _STAGED_DELEGATE_MIN = 512

    def __init__(self, snapshot: IndexSnapshot, L: int = 1024, q_bucket: int = 256,
                 checkpoint_path: Optional[str] = None, checkpoint_async: bool = True,
                 tables: Optional[HostTables] = None):
        # ALL serving state lives in one immutable bundle; see ServingState.
        # Table retention: with the compact host tables kept (`tables`,
        # auto via from_index/from_checkpoint keep_tables=True), full-result
        # lookups serve ENTIRELY host-side (lookup_host — hash probe +
        # native block decode from the compressed stream, zero device round
        # trips), the reference's mmap-read architecture (reader.go:33-103).
        # Costs host RAM ~= the compressed index; refresh keeps them current.
        self._state = ServingState(
            snapshot, removed=snapshot.removed, tables=tables,
            removed_host=tables.removed if tables is not None else None,
        )
        # writers (refresh/promotion) serialize here; serve paths never
        # take it — they read self._state once and run on that bundle
        self._refresh_lock = threading.Lock()
        # L is only the fast-path pad (lists over it re-serve exactly), and
        # every decode path works in 128-value blocks — normalize rather
        # than crash deep in the first dual-tier dispatch
        self.L = max(128, _round_up(L, 128))
        self.q_bucket = q_bucket
        # auto-checkpointing: with a path set, every MAIN-tier rebuild
        # (from_index, full refresh, delta promotion) re-persists the warm-
        # start tables there — serving restarts are always warm with zero
        # operator action. Delta-only refreshes deliberately do NOT rewrite
        # it: the stale file reconciles at load via the refresh lifecycle.
        self.checkpoint_path = checkpoint_path
        self.checkpoint_async = checkpoint_async
        self._ckpt_lock = threading.Lock()
        self._ckpt_thread: Optional[threading.Thread] = None
        # engine-internal busy probe (set by from_index/from_checkpoint to
        # the source index's is_busy): the router's PRIMARY load signal —
        # see _host_busy
        self._busy_fn: Optional[Callable[[], bool]] = None
        # warm checkpoint start's background arena upload (device_wait)
        self._upload_thread: Optional[threading.Thread] = None
        # module-level jit caches: shared across engine instances so fresh
        # snapshots of same-shaped indexes reuse compiled programs
        self._lookup = _JIT_LOOKUP
        self._boolean = _JIT_BOOLEAN
        self._prefix = _JIT_PREFIX

    # -- serving-state access -------------------------------------------------
    #
    # Read-only views of the current ServingState for introspection and
    # tests. Serve paths do NOT use these: each entry point captures
    # `st = self._state` ONCE and threads it through, so one call always
    # runs against one consistent bundle.

    @property
    def snap(self) -> IndexSnapshot:
        return self._state.snap

    @property
    def delta(self) -> Optional[IndexSnapshot]:
        return self._state.delta

    @property
    def tables(self) -> Optional[HostTables]:
        return self._state.tables

    @property
    def delta_tables(self) -> Optional[HostTables]:
        return self._state.delta_tables

    @property
    def _removed(self):
        return self._state.removed

    @property
    def _fingerprint(self):
        return self._state.fingerprint

    @property
    def _main_fp(self):
        return self._state.main_fp

    def _publish(self, st: ServingState) -> None:
        """Swap the serving state: ONE reference assignment — atomic under
        the GIL, so mid-flight readers see whole-old or whole-new."""
        self._state = st

    def _save_ckpt(self, tables: HostTables, fp) -> None:
        """Persist `tables` at checkpoint_path (async by default — the npz
        write is host IO the serving path need not wait on; saves serialize
        on a lock, and the atomic tmp+rename publish means a reader never
        sees a torn file)."""
        if self.checkpoint_path is None:
            return
        from .checkpoint import save_tables

        apply_removed = bool(fp[0]) if fp is not None else False

        def run():
            with self._ckpt_lock:
                save_tables(tables, self.checkpoint_path, fingerprint=fp,
                            apply_removed=apply_removed)

        if self.checkpoint_async:
            t = threading.Thread(target=run, daemon=True, name="tpi-ckpt-save")
            t.start()
            self._ckpt_thread = t
        else:
            run()

    def checkpoint_wait(self) -> None:
        """Block until any in-flight async checkpoint save has published."""
        t = self._ckpt_thread
        if t is not None:
            t.join()

    def _levels(self, st: Optional[ServingState] = None) -> List[int]:
        # serve paths ALWAYS pass their captured st; the default is for
        # introspection (stats/tests) only
        st = st if st is not None else self._state
        return _ladder(self.L, st.max_count())

    def _level_for(self, need: int, st: Optional[ServingState] = None) -> int:
        for lv in self._levels(st):
            if lv >= need:
                return lv
        return _round_up(need, 128)

    def warmup(self, k_max: int = 8, ops: Sequence[str] = ("and", "or")) -> int:
        """Precompile the serving programs before traffic arrives (first
        compiles cost seconds). Compiles the lookup step, the resolve step,
        and every boolean size class a corpus of this shape can hit, at one
        query bucket each. Returns the number of programs compiled."""
        st = self._state
        s = st.snap
        if s.n_terms == 0:
            return 0
        n = 0
        qk = jnp.zeros((self.q_bucket, s.width + 1), dtype=jnp.uint32)
        jax.block_until_ready(self._lookup_on(s, qk, None)[0])
        n += 1
        bqk = jnp.zeros((8, k_max, s.width + 1), dtype=jnp.uint32)
        kv = jnp.zeros((8,), dtype=jnp.int32)
        jax.block_until_ready(
            _JIT_RESOLVE(s.keys, s.counts, bqk, s.hash_slots, s.max_probes)[0]
        )
        n += 1
        max_blocks = k_max * (-(-max(1, s.max_count) // 128))
        bi = jnp.zeros((8, k_max), dtype=jnp.int32)
        bf = jnp.zeros((8, k_max), dtype=bool)
        for SB in self._SB_CLASSES:
            for op in ops:
                jax.block_until_ready(
                    _JIT_CONCAT_BOOL(
                        s.blocks, s.term_block_start, s.counts, bi, bf, kv, SB, op
                    )[0]
                )
                n += 1
            if SB >= max_blocks:
                break
        return n

    @staticmethod
    def _tables_bytes(t: Optional[HostTables]) -> int:
        if t is None:
            return 0
        return int(sum(
            a.nbytes for a in (t.keys, t.words, t.flat, t.tbs, t.counts,
                               t.removed, t.slots)
        ))

    def stats(self) -> Dict[str, int]:
        """Memory/meta counters for the frozen snapshot. host_bytes counts
        the per-term count vector (always resident); tables_bytes the
        OPTIONAL retained compact tables (keep_tables — ~compressed-index
        size, what host-side serving reads from; 0 when dropped)."""
        st = self._state
        s, d = st.snap, st.delta
        return {
            "n_terms": s.n_terms,
            "n_postings": int(s.host_counts.sum()) if s.host_counts is not None else 0,
            "max_posting_len": s.max_count,
            "device_bytes": s.device_bytes(),
            "host_bytes": int(s.host_counts.nbytes) if s.host_counts is not None else 0,
            "tables_bytes": (
                self._tables_bytes(st.tables)
                + self._tables_bytes(st.delta_tables)
            ),
            "delta_terms": 0 if d is None else d.n_terms,
            "delta_device_bytes": 0 if d is None else d.device_bytes(),
            "ladder": self._levels(st),
            "host_serving": st.host_ready(),
        }

    @classmethod
    def from_index(cls, index, L: int = 1024, apply_removed: bool = False,
                   keep_tables: bool = True, **kw):
        """Freeze `index` and serve it. keep_tables=True (default) retains
        the compact host tables already built by the freeze — enabling
        host-side full-result lookups (lookup_host) for the cost of holding
        the compressed postings in host RAM; pass False to drop them."""
        fp = _index_fingerprint(index, apply_removed)
        t = snapshot_tables(index, apply_removed=apply_removed)
        eng = cls(upload_tables(t), L=L,
                  tables=t if keep_tables else None, **kw)
        eng._publish(eng._state.replace(fingerprint=fp, main_fp=fp))
        eng._busy_fn = getattr(index, "is_busy", None)
        eng._save_ckpt(t, fp)
        return eng

    @classmethod
    def from_checkpoint(cls, path: str, index=None, L: int = 1024,
                        keep_tables: bool = True, **kw):
        """Warm-start a serving engine from a checkpoint written by
        models.checkpoint.save_checkpoint: load the compact host tables,
        upload (one gather expands the arena on device) — skipping the
        segment scan / merge / re-encode / hash build of from_index.

        With `index` given, the checkpoint is reconciled against the LIVE
        index through the normal refresh lifecycle: unchanged fingerprint =
        no extra work, additive drift = O(delta) incremental tier, merged-
        away segments or tombstone drift (under apply_removed) = full
        rebuild. Without `index`, the engine serves the checkpointed state
        as-is.

        Pass checkpoint_path=<same path> to also ADOPT the file for
        auto-resave: every subsequent main-tier rebuild re-persists it
        (opt-in — the load path may be a read-only location).

        warm_serve=True (default): the engine starts SERVING as soon as
        the host tables load — the device arena upload runs in a
        background thread and swaps in via the normal ServingState
        publish. During the window every entry point routes through the
        retained tables (ServingState.device_ready=False), bit-identical
        to the post-swap device routes. device_wait() blocks until the
        swap; warm_serve requires keep_tables (there is nothing to serve
        from otherwise) and falls back to the synchronous upload without
        it."""
        from .checkpoint import load_checkpoint, load_fingerprint

        warm_serve = bool(kw.pop("warm_serve", True)) and keep_tables
        t, meta = load_checkpoint(path)
        fp = load_fingerprint(meta)
        if not warm_serve or t.n_terms == 0:
            eng = cls(upload_tables(t), L=L,
                      tables=t if keep_tables else None, **kw)
            eng._publish(eng._state.replace(fingerprint=fp, main_fp=fp))
            if index is not None:
                eng._busy_fn = getattr(index, "is_busy", None)
                eng.refresh(index, apply_removed=bool(meta["apply_removed"]))
            return eng
        # warm start: host tables serve NOW, the arena uploads behind a
        # HOST placeholder snapshot — zero device touches in the
        # foreground: the first device contact (backend init, compiles)
        # happens in the background upload thread
        eng = cls(_empty_snapshot_host(t.width or 1), L=L, tables=t, **kw)
        host_st = eng._state.replace(fingerprint=fp, main_fp=fp,
                                     device_ready=False)
        eng._publish(host_st)

        def bg_upload():
            # chunked transfer: a monolithic jnp.asarray of the ~(words)
            # array holds the GIL for the whole send, starving the
            # host-route serving thread this warm start exists for. 1 MB
            # pieces + 10 ms handoff gaps bound each GIL hold to one chunk
            # and give serving real windows.
            snap = upload_tables(t, chunk_bytes=1 << 20)
            # block until the arena is resident so the swap never serves a
            # half-uploaded device state
            jax.block_until_ready(snap.counts)
            with eng._refresh_lock:
                cur = eng._state
                if cur is host_st:
                    eng._publish(cur.replace(snap=snap, removed=snap.removed,
                                             device_ready=True))
                # else: a refresh already published a full state — the
                # background arena is stale; drop it

        th = threading.Thread(target=bg_upload, daemon=True,
                              name="tpi-ckpt-upload")
        eng._upload_thread = th
        th.start()
        if index is not None:
            eng._busy_fn = getattr(index, "is_busy", None)
            eng.refresh(index, apply_removed=bool(meta["apply_removed"]))
        return eng

    def device_ready(self) -> bool:
        """False only during a warm checkpoint start's upload window."""
        return self._state.device_ready

    def device_wait(self) -> None:
        """Block until the warm-start background arena upload (if any) has
        swapped in. No-op otherwise."""
        th = self._upload_thread
        if th is not None:
            th.join()

    def save_checkpoint(self, index, path: str, apply_removed: bool = False) -> dict:
        """Persist this index's CURRENT state as a warm-start checkpoint
        (see models/checkpoint.py). Convenience wrapper: the freeze runs
        from the live index (host tables are not retained on the engine —
        they are the compressed-postings-sized half of a rebuild). Key
        width is re-derived from the corpus, not pinned to this engine's:
        terms grown past snap.width*4 bytes must widen, or they'd alias."""
        from .checkpoint import save_checkpoint as _save

        return _save(index, path, apply_removed=apply_removed)

    def refresh(self, index, apply_removed: bool = False) -> bool:
        """Re-freeze from the live index (serve/refresh lifecycle: queries
        keep running against the old snapshot pair until the swap —
        snapshots are immutable, so this is safe mid-flight). No-op
        (returns False) when the index is unchanged since the last freeze.

        INCREMENTAL (O(delta)): when the change is purely ADDITIVE — every
        segment of the main freeze still lives, tombstones untouched when
        apply_removed — only the new segments are merged and uploaded as a
        small DELTA snapshot; the main tables are untouched. A delta beyond
        DELTA_FRACTION of main, a compaction (segments vanished), or a
        tombstone change under apply_removed promotes to a full rebuild
        (the serve-side analogue of LSM compaction). The key width is
        re-derived from the new corpus on full rebuilds: forcing the old
        width would truncate terms that grew longer (aliasing distinct
        terms)."""
        if self._upload_thread is not None and not self._state.device_ready:
            # warm-start window: an unchanged index is a no-op without
            # waiting; real drift waits for the swap first so the rebuild
            # bases on the full device state, not the placeholder
            if _index_fingerprint(index, apply_removed) == \
                    self._state.fingerprint:
                return False
            self.device_wait()
        with self._refresh_lock:
            base = self._state
            fp = _index_fingerprint(index, apply_removed)
            if fp == base.fingerprint:
                return False
            if base.fingerprint is not None and self._try_delta_refresh(
                index, fp, apply_removed
            ):
                return True
            t = snapshot_tables(index, apply_removed=apply_removed)
            snap = upload_tables(t)
            keep = base.tables is not None
            self._publish(ServingState(
                snap, removed=snap.removed,
                tables=t if keep else None,
                removed_host=t.removed if keep else None,
                fingerprint=fp, main_fp=fp,
            ))
            self._save_ckpt(t, fp)
            return True

    def _try_delta_refresh(self, index, fp, apply_removed: bool) -> bool:
        """Attempt the O(delta) incremental tier; publishes the new state
        (fingerprint included) and returns True on success. Runs under
        _refresh_lock (refresh is the only caller)."""
        base = self._state
        main_fp = base.main_fp
        if main_fp is None or main_fp[0] != apply_removed:
            return False
        main_shards = {k: (segs, rl) for k, segs, rl in main_fp[1]}
        for key, segs, rl in fp[1]:
            base_segs, base_rl = main_shards.get(key, ((), 0))
            if not set(base_segs).issubset(segs):
                return False  # a main segment was merged away: full rebuild
            if apply_removed and rl != base_rl:
                return False  # purge baseline changed: full rebuild
        base_map = {k: frozenset(segs) for k, segs, rl in main_fp[1]}
        # under apply_removed the main tier was purged at build: purge the
        # delta against the SAME (unchanged — checked above) tombstone set,
        # so the pair is bit-identical to a full purged rebuild
        rem = _collect_removed(index) if apply_removed else None
        keep = base.tables is not None
        built = snapshot_new_segments(index, base_map, removed=rem,
                                      with_tables=keep)
        if built is None:
            # nothing new on disk (e.g. only tombstones, not applied) —
            # still refresh the tombstone array below
            delta, dt = base.delta, base.delta_tables
        else:
            delta, dt = built if keep else (built, None)
            main_terms = max(1, base.snap.n_terms)
            if delta.n_terms > self.DELTA_FRACTION * main_terms:
                # promote: fold the delta into main by merging the two
                # SNAPSHOT tiers directly (no segment re-read)
                return self._promote_delta(index, fp, apply_removed, delta)
        removed, removed_host = base.removed, base._removed_host
        if not apply_removed:
            rem_h = _collect_removed(index)
            removed, removed_host = jnp.asarray(rem_h), rem_h
        self._publish(base.replace(
            delta=delta, delta_tables=dt if keep else None,
            removed=removed, removed_host=removed_host, fingerprint=fp,
        ))
        return True

    def _promote_delta(self, index, fp, apply_removed: bool, delta) -> bool:
        """Fold an oversized delta into the main tier by merging the two
        snapshots' OWN arrays (decode on device, one two-way key merge,
        re-encode) — O(main + delta tables) instead of the from-disk
        rebuild's O(re-read + re-merge every segment). Bit-identical to
        snapshot_index(index, apply_removed) under this path's
        preconditions (every main segment still live; tombstones unchanged
        when apply_removed — both checked by _try_delta_refresh)."""
        base = self._state
        tiers = [_SnapshotTier(base.snap, self), _SnapshotTier(delta, self)]
        merged = merge_views(tiers, None)
        if merged is None:  # pragma: no cover - both tiers empty
            return False
        blob, offsets, values, voffs = merged
        rem = None if apply_removed else _collect_removed(index)
        t = build_host_tables(blob, offsets, values, voffs, rem)
        snap = upload_tables(t)
        keep = base.tables is not None
        self._publish(ServingState(
            snap, removed=snap.removed,
            tables=t if keep else None,
            removed_host=t.removed if keep else None,
            fingerprint=fp, main_fp=fp,
        ))
        self._save_ckpt(t, fp)
        return True

    # -- exact lookup --------------------------------------------------------

    def lookup_device(self, qkeys: jnp.ndarray, filter_removed: bool = False, L: Optional[int] = None):
        """Raw device step over the MAIN snapshot (bench/power users; the
        delta tier is a host-level concern — use lookup() for union
        semantics across both tiers)."""
        st = self._state
        return self._lookup_on(
            st.snap, qkeys, st.removed if filter_removed else None, L
        )

    def _lookup_on(self, s: IndexSnapshot, qkeys, removed, L: Optional[int] = None):
        return self._lookup(
            s.keys, s.blocks, s.term_block_start, s.counts, qkeys,
            L or self.L, s.hash_slots, s.max_probes, removed,
        )

    def lookup(
        self, terms: Sequence[bytes], filter_removed: bool = False
    ) -> List[Optional[np.ndarray]]:
        """Host convenience: exact postings per term (None for misses).
        filter_removed applies the vectorized tombstone mask per row.
        Terms whose lists exceed L are re-served at a larger ladder L —
        results are always exact and fully device-decoded. With a delta
        snapshot live (incremental refresh), a term's result is the union
        of its rows in both tiers."""
        if not terms:
            return []
        st = self._state
        if not st.device_ready and st.host_ready():
            # warm checkpoint window: serve from the retained tables
            return self.lookup_host(terms, filter_removed)
        main = self._exact_rows(st, st.snap, terms, filter_removed)
        if st.delta is None:
            return main
        dl = self._exact_rows(st, st.delta, terms, filter_removed)
        out: List[Optional[np.ndarray]] = []
        for a, b in zip(main, dl):
            if a is None:
                out.append(b)
            elif b is None:
                out.append(a)
            else:
                out.append(np.union1d(a, b))
        return out


    def _exact_rows(
        self, st: ServingState, s: IndexSnapshot, terms: Sequence[bytes],
        filter_removed: bool,
    ) -> List[Optional[np.ndarray]]:
        if s.n_terms == 0:
            return [None] * len(terms)
        removed = st.removed if filter_removed else None
        Q = _round_up(len(terms), self.q_bucket)
        qk = keys_mod.pack_terms(list(terms), width=s.width)
        pad = np.repeat(qk[-1:], Q - len(terms), axis=0)
        qk_p = np.concatenate([qk, pad], axis=0)
        found, vals, n, raw = self._lookup_on(s, jnp.asarray(qk_p), removed)
        found, vals, n, raw = jax.device_get((found, vals, n, raw))
        out: List[Optional[np.ndarray]] = [None] * len(terms)
        long_idx = []
        for i in range(len(terms)):
            if not found[i]:
                continue
            if raw[i] > self.L:
                long_idx.append(i)  # exact re-serve below
            else:
                out[i] = vals[i, : n[i]].copy()
        # largest need first: each batch then re-serves at ITS level instead
        # of every batch paying the global max level
        long_idx.sort(key=lambda i: -raw[i])
        # exact re-serve of long lists, grouped by ladder level
        while long_idx:
            need = int(max(raw[i] for i in long_idx))
            lv = self._level_for(need, st)
            qb = max(1, _RESERVE_BUDGET // lv)
            batch, long_idx = long_idx[:qb], long_idx[qb:]
            B = len(batch)
            bq = np.repeat(qk[batch[-1] : batch[-1] + 1], _round_up(B, 8), axis=0)
            bq[:B] = qk[batch]
            f2, v2, n2, _ = self._lookup_on(s, jnp.asarray(bq), removed, L=lv)
            n2 = np.asarray(n2)
            v2 = np.asarray(v2[:, : max(1, int(n2.max(initial=0)))])
            for j, i in enumerate(batch):
                out[i] = v2[j, : n2[j]].copy()
        return out

    # -- transport-aware routing --------------------------------------------
    #
    # The host-route serving mechanics live in models/host_serve.py
    # (HostServingMixin); the pipelined streams in models/staged.py
    # (StagedStreamsMixin). The ROUTING POLICY between them stays here,
    # next to the link probe it reads (_link_mbps above).

    _HOST_ROUTE_LINK_MBPS = 256.0
    _HOST_ROUTE_OR_LINK_MBPS = 1024.0

    def _host_busy(self) -> bool:
        """Load-aware routing signal: the host route's whole advantage is
        zero link bytes at the cost of host CPU; with the CPU gone, the
        staged DEVICE pipeline (host does only pack+fetch) degrades far
        less — so staged streams fall back to it while the host is busy.

        PRIMARY signal: the serving engine's own index (wired by
        from_index/from_checkpoint as `_busy_fn` = InvertedIndex.is_busy)
        — True exactly while a put/put_removed/merge call is in flight, so
        the route flips within one batch of a merge starting or stopping.
        FALLBACK for external contenders: 1-minute loadavg per core above
        TPI_HOST_BUSY_LOAD (default 1.5) — slow to rise (a merge burst is
        invisible for its first seconds) and slow to clear (~a minute), so
        it only covers load the engine cannot see. TPI_HOST_BUSY_LOAD=0
        disables BOTH signals (always-host links); measured contended-vs-
        idle numbers: bench_host_contended."""
        thresh = float(os.environ.get("TPI_HOST_BUSY_LOAD", "1.5"))
        if thresh <= 0:
            return False
        fn = self._busy_fn
        if fn is not None and fn():
            return True
        try:
            load = os.getloadavg()[0]
        except OSError:  # pragma: no cover - platform-dependent
            return False
        return load / max(1, os.cpu_count() or 1) > thresh

    def _host_boolean_route(
        self, op: str, prefix_p: int = 0, staged: bool = False,
        st: Optional[ServingState] = None,
    ) -> bool:
        """Transport-aware serving route (requires retained tables), per-op
        thresholds against one measured link probe per process (_link_mbps):

        * full-result OR routes host-side below 1024 MB/s: the union IS the
          output (O(sum of posting lengths) ships no matter who computes
          it), so on a slow link the SIMD host serve (zero link bytes)
          beats the fetch-bound device route.
        * AND (one-shot AND staged) routes host-side below 256 MB/s: the
          fused native serve (count-ordered block-skip streaming
          intersection, tpi_boolean_serve) then beats the device's
          dispatch- and fetch-bound routes.

        Both thresholds were set on a slow remote link and are not yet
        measured on a PCIe-attached card. Pagination (prefix_p) stays on
        the device: its fetch is already bounded.
        TPI_HOST_BOOL=or|and|all|0|auto overrides the policy."""
        st = st if st is not None else self._state
        if not st.device_ready and st.host_ready():
            # warm checkpoint window: the device snapshot is a placeholder
            # while the arena uploads — EVERY shape (prefix_p and pinned
            # modes included) serves host-side until the swap
            return True
        if prefix_p or not st.host_ready():
            return False
        mode = os.environ.get("TPI_HOST_BOOL", "auto")
        if mode == "auto":
            if op == "or":
                if staged and self._host_busy():
                    # best-available under load: the pipelined staged
                    # device concat stream; one-shot OR stays host — the
                    # non-pipelined device OR is fetch-volume-bound
                    return False
                return _link_mbps() < self._HOST_ROUTE_OR_LINK_MBPS
            if staged and self._host_busy():
                return False  # load-aware fallback: see _host_busy
            return _link_mbps() < self._HOST_ROUTE_LINK_MBPS
        return mode == "all" or mode == op

    # -- boolean queries ---------------------------------------------------------

    def _pack_boolean(self, st: ServingState, queries):
        """Pack a query batch -> (qk (Q, K, W+1) uint32, kv (Q,) int32),
        Q padded to the engine's q_bucket. ONE pack over the flattened
        terms (a per-query pack_terms loop is Python-bound at 10k-query
        batches); packed at the max width across tiers and narrowed per
        tier at dispatch."""
        nq = len(queries)
        Q = _round_up(nq, self.q_bucket)
        # ONE C-level length pass (map(len)) feeds both K and kv instead of
        # two pure-Python iterations over the batch
        kv = np.zeros(Q, dtype=np.int32)
        kv[:nq] = np.fromiter(map(len, queries), np.int32, count=nq)
        K = max(1, int(kv.max(initial=0)))
        W = st.width()
        qk = np.zeros((Q, K, W + 1), dtype=np.uint32)
        flat_terms = list(it.chain.from_iterable(queries))  # C-level flatten
        packed = keys_mod.pack_terms(flat_terms, width=W)
        kvq = kv[: len(queries)].astype(np.int64)
        rows = np.repeat(np.arange(len(queries)), kvq)
        # slot-within-query, vectorized (a per-query np.arange concat was
        # the pack's dominant term)
        qoffs = np.zeros(len(queries) + 1, dtype=np.int64)
        np.cumsum(kvq, out=qoffs[1:])
        cols = np.arange(qoffs[-1], dtype=np.int64) - np.repeat(qoffs[:-1], kvq)
        qk[rows, cols] = packed
        return qk, kv

    def _pack_boolean_cols(self, st: ServingState, blob, offsets, qoffs):
        """Columnar query batch -> (qk, kv): `blob` all query terms'
        bytes concatenated, `offsets[T+1]` term bounds in it, `qoffs[Q+1]`
        each query's term range. Skips every Python-object cost of the
        list-of-lists pack (flatten + join + per-term len, most of its host
        time) — callers that already hold queries in wire/columnar form
        should prefer it."""
        W = st.width()
        offsets = np.asarray(offsets, dtype=np.int64)
        qoffs = np.asarray(qoffs, dtype=np.int64)
        nq = len(qoffs) - 1
        kvq = np.diff(qoffs)
        K = max(1, int(kvq.max(initial=1)))
        Q = _round_up(nq, self.q_bucket)
        qk = np.zeros((Q, K, W + 1), dtype=np.uint32)
        kv = np.zeros(Q, dtype=np.int32)
        kv[:nq] = kvq
        blob8 = (
            np.frombuffer(blob, dtype=np.uint8)
            if isinstance(blob, (bytes, bytearray))
            else np.asarray(blob, dtype=np.uint8)
        )
        packed = keys_mod.pack_blob(blob8, offsets, W)
        rows = np.repeat(np.arange(nq), kvq)
        cols = np.arange(qoffs[-1], dtype=np.int64) - np.repeat(qoffs[:-1], kvq)
        qk[rows, cols] = packed
        return qk, kv

    def _batch_pack(self, st: ServingState, queries):
        """One stream batch -> (nq, qk, kv). Accepts a sequence of term
        lists OR a columnar (blob, offsets, qoffs) triple (see
        _pack_boolean_cols)."""
        if isinstance(queries, tuple) and len(queries) == 3:
            _, _, qoffs = queries
            nq = len(qoffs) - 1
            if nq <= 0:
                return 0, None, None
            qk, kv = self._pack_boolean_cols(st, *queries)
            return nq, qk, kv
        if not queries:
            return 0, None, None
        qk, kv = self._pack_boolean(st, queries)
        return len(queries), qk, kv

    def boolean(self, queries: Sequence[Sequence[bytes]], op: str, filter_removed: bool = False):
        """Batch of AND/OR queries; each query is 1..K terms.

        Returns list of np arrays (sorted unique values). A missing term makes
        an AND query empty; contributes nothing to an OR query. Queries whose
        posting lists exceed L are re-served exactly at a larger ladder L —
        fully on device, no host set algebra.
        """
        if not queries:
            return []
        st = self._state
        if self._host_boolean_route(op, st=st):
            # output-bound op with tables retained: serve host-side, zero
            # round trips (see boolean_host)
            return self.boolean_host(queries, op, filter_removed, _st=st)
        if (len(queries) >= self._STAGED_DELEGATE_MIN
                and st.snap.n_terms > 0):
            # device route at bulk Q: a one-shot call is the SAME contract
            # as a single-batch staged stream, but the staged machinery
            # pipelines class dispatches, coalesces fetches, and batches
            # ladder re-serves. Naive callers get the fast path without
            # knowing boolean_staged exists (the reference serves every
            # caller through one Read path, inverted_index.go:300).
            # n_terms==0 must NOT delegate: boolean_staged's empty-index
            # fallback calls back into boolean().
            return self.boolean_staged(
                [queries], op, filter_removed, _st=st)[0]
        s = st.snap
        qk, kv = self._pack_boolean(st, queries)
        if s.n_terms == 0 and st.delta is None:
            return [np.zeros(0, np.uint32) for _ in queries]
        removed = st.removed if filter_removed else None
        if st.delta is None:
            # steady state: concat-decode path — work proportional to each
            # query's TOTAL posting count, no truncation/re-serve at all
            return self._boolean_concat(st, queries, qk, kv, op, removed)

        def run(lv, qk_sub, kv_sub):
            """One device pass at pad lv over the main+delta pair."""
            d = st.delta
            return _JIT_BOOLEAN_DUAL(
                s.keys, s.blocks, s.term_block_start, s.counts, s.hash_slots,
                d.keys, d.blocks, d.term_block_start, d.counts, d.hash_slots,
                jnp.asarray(_narrow_keys(qk_sub, s.width)),
                jnp.asarray(_narrow_keys(qk_sub, d.width)),
                jnp.asarray(kv_sub),
                lv, op, removed, s.max_probes, d.max_probes,
            )

        out, oc, need = run(self.L, qk, kv)
        # ONE device_get per round trip: separate np.asarray calls each pay
        # the transfer latency; the base-pass matrix is small enough to
        # ship untrimmed in the same fetch
        out, oc, need = jax.device_get((out, oc, need))
        results: List[Optional[np.ndarray]] = [None] * len(queries)
        long_idx = sorted(
            (i for i in range(len(queries)) if need[i] > self.L),
            key=lambda i: -need[i],
        )
        for i in range(len(queries)):
            if need[i] <= self.L:
                results[i] = out[i, : oc[i]].copy()
        # exact re-serve at the smallest ladder level that fits, small batches
        self._reserve_ladder(st, results, long_idx, need, qk, kv, run)
        return results

    def _reserve_ladder(self, st, results, long_idx, need, qk, kv, run):
        """Exact ladder re-serves of the padded dual-tier boolean path:
        batches of clipped queries (largest need first — each batch
        re-serves at ITS level, not the global max) re-run through `run`
        at the smallest ladder level that fits, and the padded result
        matrix is trimmed to the populated prefix before download (it can
        be tens of MB; results are narrow)."""
        K, Wp1 = qk.shape[1], qk.shape[2]
        while long_idx:
            lv = self._level_for(int(max(need[i] for i in long_idx)), st)
            qb = max(1, _RESERVE_BUDGET // (K * lv))
            batch, long_idx = long_idx[:qb], long_idx[qb:]
            B = _round_up(len(batch), 8)
            bq = np.zeros((B, K, Wp1), dtype=np.uint32)
            bkv = np.zeros(B, dtype=np.int32)
            bq[: len(batch)] = qk[batch]
            bkv[: len(batch)] = kv[batch]
            o2, c2, _ = run(lv, bq, bkv)
            c2 = np.asarray(c2)
            o2 = np.asarray(o2[:, : max(1, int(c2.max(initial=0)))])
            for j, i in enumerate(batch):
                results[i] = o2[j, : c2[j]].copy()

    # size classes for the concat path: total-block budgets per query.
    # Geometric x4 keeps compiled programs few; each class pays only its
    # own real volume (SB*128 values sorted per query). One x2 step (64)
    # sits at the config-3 modal query size of 33-64 blocks. The ladder
    # was tuned on another accelerator and is not yet measured on the GPU.
    _SB_CLASSES = (8, 32, 64, 128, 512, 2048, 8192, 32768)

    # assumed device cost of one concat-stream row (us) in the dedup
    # benefit gate below; not yet measured on the GPU
    _DEDUP_ROW_COST_US = 10.0

    def _dedup_batch(self, nq: int, qk, kv):
        """Cross-query dedup for a staged concat-stream batch:
        Zipf-distributed traffic repeats whole (term-set) queries — the
        top term pair alone can recur hundreds of times per 8k batch — and
        the stream would decode and sort each copy. Group identical packed
        rows host-side at pack time, serve the UNIQUE rows, and fan results
        back out through the inverse map at assembly (bit-identical; a
        duplicate is the same query).

        Returns (nu, qk_u, kv_u, inv) with inv None when dedup does not
        pay: fewer than 64 queries, TPI_STAGED_DEDUP=0, or too few
        duplicates — the unique rows pad up to a batch-size/16 grid so
        compiled shapes stay few (<= 16 per BATCH size, which can exceed
        q_bucket in staged streams; a per-batch exact nu would recompile
        the staged programs every batch), so savings below one grid step
        are not real.

        Cost model: exact grouping is a hash + u64 argsort + adjacent
        full-row verify (a structured-dtype np.unique sort was several
        times slower). The duplicate CHECK is a hash-only unique, paid
        always; the full grouping only runs when the estimated device
        saving (removed rows x _DEDUP_ROW_COST_US) clears a 4 ms bar."""
        mode = os.environ.get("TPI_STAGED_DEDUP", "1")
        if nq < 64 or mode == "0":
            return nq, qk, kv, None
        flat = np.ascontiguousarray(qk[:nq].reshape(nq, -1))
        comb = np.concatenate(
            [flat.astype(np.int64, copy=False),
             kv[:nq].astype(np.int64).reshape(nq, 1)], axis=1)
        # 64-bit row hash: collisions only MERGE candidate groups for the
        # cheap check below and are re-split exactly by the full-row verify
        mults = self._dedup_mults(comb.shape[1])
        h = comb @ mults
        grid = max(8, _round_up(nq, 8) // 16)
        nu_h = len(np.unique(h))
        target = _round_up(nu_h, grid)
        if target >= _round_up(nq, grid):
            return nq, qk, kv, None  # not enough duplicates to shrink
        # benefit gate: saved rows x per-row serve cost must clear the
        # ~2 ms grouping + fan-out overhead with margin (2x). "force"
        # (tests / known-hot traffic) skips the gate, never the shrink
        # check.
        saved_rows = _round_up(nq, grid) - target
        if (mode != "force"
                and saved_rows * self._DEDUP_ROW_COST_US < 2 * 2000.0):  # us
            return nq, qk, kv, None
        order = np.argsort(h, kind="stable")
        sc = comb[order]
        neq = np.empty(nq, dtype=bool)
        neq[0] = True
        np.any(sc[1:] != sc[:-1], axis=1, out=neq[1:])
        first = order[neq]
        gid = np.cumsum(neq) - 1
        inv = np.empty(nq, dtype=np.int32)
        inv[order] = gid.astype(np.int32)
        nu = len(first)
        target = _round_up(nu, grid)  # exact nu (hash collisions re-split)
        qk_u = np.zeros((target,) + qk.shape[1:], dtype=qk.dtype)
        kv_u = np.zeros(target, dtype=kv.dtype)
        qk_u[:nu] = qk[:nq][first]
        kv_u[:nu] = kv[:nq][first]
        return nu, qk_u, kv_u, inv

    @classmethod
    def _dedup_mults(cls, n: int):
        """Fixed odd multipliers for the dedup row hash (deterministic,
        seed-free); grown on demand for wide (K x width) packed rows."""
        m = cls.__dict__.get("_DEDUP_MULTS_CACHE")
        if m is None or len(m) < n:
            m = np.array(
                [(0x9E3779B97F4A7C15 - (i * 2 + 1) * 0x61C8864680B583EB)
                 & 0xFFFFFFFFFFFFFFFF for i in range(max(n, 64))],
                dtype=np.uint64,
            ).astype(np.int64)
            cls._DEDUP_MULTS_CACHE = m
        return m[:n]

    def _drain_levels(self, items, run, setter):
        """Two-wave exact re-serve drain. items: (pos, qk_row (K_i, W+1),
        kv, lv) — lv the pad level to serve at (callers precompute; a
        batch serves at the level of its LARGEST member, which is exact
        for every smaller member in it). All dispatches are issued
        back-to-back with async count copies, then counts fetch in one
        wave and trimmed results in a second; in-flight HBM is capped at
        4x the reserve budget (a cap hit drains early and continues)."""
        dispatches = []  # (members, out_dev, cnt_dev)
        pend_bytes = 0

        def drain():
            nonlocal pend_bytes
            counts = jax.device_get([d[2] for d in dispatches])
            trimmed = [
                d[1][:, : max(1, int(c[: len(d[0])].max(initial=0)))]
                for d, c in zip(dispatches, counts)
            ]
            outs = jax.device_get(trimmed)
            for (members, _, _), c, o in zip(dispatches, counts, outs):
                for j, t in enumerate(members):
                    setter(t[0], o[j, : c[j]].copy())
            dispatches.clear()
            pend_bytes = 0

        items.sort(key=lambda t: -t[3])
        idx = 0
        while idx < len(items):
            lv = int(items[idx][3])
            K = max(t[1].shape[0] for t in items)
            qb = max(1, _RESERVE_BUDGET // (K * lv))
            batch = items[idx : idx + qb]
            idx += len(batch)
            B = _round_up(len(batch), 8)
            bq = self._stack_rows([t[1] for t in batch], B)
            bkv = np.zeros(B, dtype=np.int32)
            bkv[: len(batch)] = [t[2] for t in batch]
            o2, c2, _ = run(lv, bq, bkv)
            c2.copy_to_host_async()
            dispatches.append((batch, o2, c2))
            pend_bytes += B * lv * 4
            if pend_bytes > 4 * _RESERVE_BUDGET:
                drain()
        if dispatches:
            drain()

    @staticmethod
    def _stack_rows(rows, B):
        """Stack per-query (K_b, W+1) key rows (possibly different K across
        batches) into a (B, Kmax, W+1) matrix."""
        Kmax = max(r.shape[0] for r in rows)
        Wp1 = rows[0].shape[1]
        bq = np.zeros((B, Kmax, Wp1), dtype=np.uint32)
        for j, r in enumerate(rows):
            bq[j, : r.shape[0]] = r
        return bq

    # -- exact decode by term index (ladder-grouped) --------------------------------

    def _decode_indices(self, idx: np.ndarray, s: IndexSnapshot,
                        st: Optional[ServingState] = None) -> tuple[np.ndarray, np.ndarray]:
        """Exact postings of dictionary indices `idx` in snapshot `s`:
        (values, voffs[n+1]). `st` supplies the ladder (defaults to a
        single-tier view of `s` — correct for promotion-time decodes that
        act on one explicit tier).

        Rows are decoded on device in batches grouped by the smallest ladder
        L that fits each row's TRUE count — every posting list is served
        exactly regardless of length (no host posting mirror exists)."""
        ladder = (
            self._levels(st) if st is not None
            else _ladder(self.L, s.max_count)
        )
        n = len(idx)
        counts = s.host_counts[idx].astype(np.int64)
        voffs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=voffs[1:])
        flat = np.empty(int(voffs[-1]), dtype=np.uint32)
        if n == 0:
            return flat, voffs
        levels = np.array([self.L] + ladder, dtype=np.int64)
        lvl_idx = np.searchsorted(levels, counts, side="left")
        for li in np.unique(lvl_idx):
            lv = int(levels[li])
            sel = np.nonzero(lvl_idx == li)[0]
            qb = max(1, _RESERVE_BUDGET // lv)
            for c0 in range(0, len(sel), qb):
                ss = sel[c0 : c0 + qb]
                B = _round_up(len(ss), 8)
                bi = np.full(B, idx[ss[-1]], dtype=np.int32)
                bi[: len(ss)] = idx[ss]
                v, _ = _JIT_DECODE(
                    s.blocks, s.term_block_start, s.counts, jnp.asarray(bi), lv
                )
                w = min(max(1, int(counts[ss].max())), lv)
                v = np.asarray(v[: len(ss), :w])
                m = np.arange(w, dtype=np.int64)[None, :] < counts[ss][:, None]
                dst = (voffs[ss][:, None] + np.arange(w, dtype=np.int64)[None, :])[m]
                flat[dst] = v[m]
        return flat, voffs

    # -- range read -----------------------------------------------------------------

    _RANGE_CHUNK = 4096

    def read_range(self, min_term: Optional[bytes] = None, max_term: Optional[bytes] = None):
        """Sorted (term, values) stream over [min,max] inclusive from the
        frozen snapshot pair — range resolution (two key searches), term
        bytes reconstructed from the key matrix, postings decoded in
        chunks. Matches InvertedIndex.read() semantics on the frozen state;
        with a delta live, the two tiers merge-join by term (values union
        on ties — types.go:14-22 semantics).

        Range reads are pure output (no set algebra for a device to add
        value to): with retained tables (host_ready) the stream serves
        entirely HOST-side — native decode, zero round trips; otherwise
        postings device-decode and fetch per chunk."""
        st = self._state
        host = st.host_ready()
        main = (
            self._read_range_on_tables(st.tables, min_term, max_term)
            if host else self._read_range_on(st, st.snap, min_term, max_term)
        )
        if st.delta is None:
            yield from main
            return
        dl = (
            self._read_range_on_tables(st.delta_tables, min_term, max_term)
            if host else self._read_range_on(st, st.delta, min_term, max_term)
        )
        a = next(main, None)
        b = next(dl, None)
        while a is not None or b is not None:
            if b is None or (a is not None and a[0] < b[0]):
                yield a
                a = next(main, None)
            elif a is None or b[0] < a[0]:
                yield b
                b = next(dl, None)
            else:
                yield a[0], np.union1d(a[1], b[1])
                a = next(main, None)
                b = next(dl, None)

    def _read_range_on(self, st, s: IndexSnapshot, min_term, max_term):
        if s.n_terms == 0:
            return
        lo = 0 if min_term is None else int(
            np.asarray(
                ds.searchsorted_rows(
                    s.keys,
                    jnp.asarray(keys_mod.pack_terms([min_term], width=s.width)),
                )
            )[0]
        )
        if max_term is None:
            hi = s.n_terms
        else:
            qk = keys_mod.pack_terms([max_term], width=s.width)
            hi = int(np.asarray(ds.searchsorted_rows(s.keys, jnp.asarray(qk), side="right"))[0])
        for c0 in range(lo, hi, self._RANGE_CHUNK):
            c1 = min(c0 + self._RANGE_CHUNK, hi)
            kr = np.asarray(s.keys[c0:c1])  # fetch only the range's key rows
            blob, offs = keys_mod.unpack_keys(kr)
            vals, voffs = self._decode_indices(np.arange(c0, c1), s, st)
            for j in range(c1 - c0):
                yield (
                    blob[offs[j] : offs[j + 1]].tobytes(),
                    vals[voffs[j] : voffs[j + 1]],
                )

    def _read_range_on_tables(self, t: HostTables, min_term, max_term):
        """read_range served from the retained tables: host key search +
        native block decode, no device involvement."""
        if t.n_terms == 0:
            return
        lo = 0 if min_term is None else int(
            keys_mod.searchsorted_rows(
                t.keys, keys_mod.pack_terms([min_term], width=t.width)
            )[0]
        )
        hi = t.n_terms if max_term is None else int(
            keys_mod.searchsorted_rows(
                t.keys, keys_mod.pack_terms([max_term], width=t.width),
                side="right",
            )[0]
        )
        for c0 in range(lo, hi, self._RANGE_CHUNK):
            c1 = min(c0 + self._RANGE_CHUNK, hi)
            blob, offs = keys_mod.unpack_keys(t.keys[c0:c1])
            vals, voffs = self._host_decode(t, np.arange(c0, c1))
            for j in range(c1 - c0):
                yield (
                    blob[offs[j] : offs[j + 1]].tobytes(),
                    vals[voffs[j] : voffs[j + 1]],
                )

    # -- prefix search --------------------------------------------------------------

    def prefix_search(self, prefixes: Sequence[bytes]) -> Dict[bytes, np.ndarray]:
        """Range resolution + vectorized union of decoded rows.

        Parity with InvertedIndex.prefix_search (inverted_index.go:192-295):
        unmatched prefixes absent; values sorted unique. With a delta live,
        results union across both tiers. Output-bound like read_range, so
        retained tables (host_ready) serve it host-side."""
        st = self._state
        host = st.host_ready()
        if host:
            on = self._prefix_on_tables
        else:
            def on(s, ps):
                return self._prefix_on(st, s, ps)
        out = on(st.tables if host else st.snap, prefixes)
        if st.delta is None:
            return out
        for p, v in on(
            st.delta_tables if host else st.delta, prefixes
        ).items():
            out[p] = np.union1d(out[p], v) if p in out else v
        return out

    def _prefix_on_tables(self, t: HostTables, prefixes) -> Dict[bytes, np.ndarray]:
        if t.n_terms == 0 or not prefixes:
            return {}
        lo_k, hi_k = keys_mod.prefix_bounds(list(prefixes), t.width)
        lo = keys_mod.searchsorted_rows(t.keys, lo_k)
        hi = keys_mod.searchsorted_rows(t.keys, hi_k)
        spans = [
            (p, int(lo[i]), int(hi[i]))
            for i, p in enumerate(prefixes)
            if hi[i] > lo[i]
        ]
        if not spans:
            return {}
        all_idx = np.concatenate([np.arange(a, b) for _, a, b in spans])
        vals, voffs = self._host_decode(t, all_idx)
        out: Dict[bytes, np.ndarray] = {}
        k0 = 0
        for p, a, b in spans:
            k1 = k0 + (b - a)
            out[p] = np.unique(vals[voffs[k0] : voffs[k1]])
            k0 = k1
        return out

    def _prefix_on(self, st, s: IndexSnapshot, prefixes) -> Dict[bytes, np.ndarray]:
        if s.n_terms == 0 or not prefixes:
            return {}
        lo_k, hi_k = keys_mod.prefix_bounds(list(prefixes), s.width)
        lo, hi = self._prefix(s.keys, jnp.asarray(lo_k), jnp.asarray(hi_k))
        lo, hi = np.asarray(lo), np.asarray(hi)
        spans = [
            (p, int(lo[i]), int(hi[i]))
            for i, p in enumerate(prefixes)
            if hi[i] > lo[i]
        ]
        if not spans:
            return {}
        all_idx = np.concatenate([np.arange(a, b) for _, a, b in spans])
        vals, voffs = self._decode_indices(all_idx, s, st)
        out: Dict[bytes, np.ndarray] = {}
        k0 = 0
        for p, a, b in spans:
            k1 = k0 + (b - a)
            out[p] = np.unique(vals[voffs[k0] : voffs[k1]])
            k0 = k1
        return out
