"""Frozen index snapshots: device arrays (IndexSnapshot), compact host
tables (HostTables), and the freeze paths from a live InvertedIndex.

Split out of models/query_engine.py (which re-exports every name here, so
external imports are unchanged). Reference provenance notes live on each
item; the snapshot semantics contract is documented on snapshot_tables.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import time

import numpy as np

import jax
import jax.numpy as jnp

from ..codec import hashing
from ..codec import keys as keys_mod
from ..codec import packing
from ..shard import merge_views


@dataclass
class IndexSnapshot:
    """Immutable device-resident image of one index (or one shard group).

    Fully self-contained on device: keys losslessly hold the term bytes
    (codec/keys.py), the arena holds every posting block, so NO host mirror
    of terms/postings exists (long posting lists are served exactly by
    re-decoding at a larger static L — see QueryEngine). `host_counts` is
    the one host-side array (N int32) used to pick re-serve L levels and
    size prefix unions.
    """

    keys: jnp.ndarray               # (N, W+1) uint32
    blocks: jnp.ndarray             # (B, stride) uint32 block row arena
    term_block_start: jnp.ndarray   # (N+1,) int32
    counts: jnp.ndarray             # (N,) int32
    removed: jnp.ndarray            # (R,) uint32 sorted
    width: int                      # W (words per packed term, excl. len)
    hash_slots: jnp.ndarray = None  # (S,) int32 linear-probe table (-1 empty)
    max_probes: int = 1             # static probe bound (longest chain)
    max_count: int = 0              # longest posting list (host int)
    host_counts: np.ndarray = field(repr=False, default=None)  # (N,) int32

    @property
    def n_terms(self) -> int:
        return int(self.keys.shape[0])

    def device_bytes(self) -> int:
        """Resident HBM footprint of the snapshot tables."""
        arrs = (self.keys, self.blocks, self.term_block_start, self.counts,
                self.removed, self.hash_slots)
        return int(sum(a.size * a.dtype.itemsize for a in arrs if a is not None))


def _empty_snapshot_host(width: int = 1) -> IndexSnapshot:
    """Placeholder snapshot with HOST (numpy) arrays — zero device touches.
    Used as the warm-checkpoint window's stand-in snapshot: during the
    window every serve path routes host-side (ServingState.device_ready is
    False), so materializing the placeholder on device would only serve to
    pay the backend init + a handful of compiles in the FOREGROUND — the
    cost the warm start exists to avoid. The background upload publishes
    the real device snapshot; nothing reads these arrays on device."""
    return IndexSnapshot(
        keys=np.zeros((0, width + 1), dtype=np.uint32),
        blocks=np.zeros((1, 4), dtype=np.uint32),
        term_block_start=np.zeros((1,), dtype=np.int32),
        counts=np.zeros((0,), dtype=np.int32),
        removed=np.zeros((0,), dtype=np.uint32),
        width=width,
        hash_slots=np.full((8,), -1, dtype=np.int32),
        max_probes=1,
        max_count=0,
        host_counts=np.zeros(0, dtype=np.int32),
    )


def _empty_snapshot(width: int = 1) -> IndexSnapshot:
    return IndexSnapshot(
        keys=jnp.zeros((0, width + 1), dtype=jnp.uint32),
        blocks=jnp.zeros((1, 4), dtype=jnp.uint32),
        term_block_start=jnp.zeros((1,), dtype=jnp.int32),
        counts=jnp.zeros((0,), dtype=jnp.int32),
        removed=jnp.zeros((0,), dtype=jnp.uint32),
        width=width,
        hash_slots=jnp.full((8,), -1, dtype=jnp.int32),
        max_probes=1,
        max_count=0,
        host_counts=np.zeros(0, dtype=np.int32),
    )


@jax.jit
def _expand_arena_step(wpad, flat, col):
    return wpad[flat[:, None] + col[None, :]]


def _expand_arena(wpad, flat, stride: int):
    col = jnp.arange(stride, dtype=jnp.int32)
    return _expand_arena_step(wpad, flat, col)


@dataclass
class HostTables:
    """Compact host-side image of one snapshot build: everything needed to
    (re)materialize an IndexSnapshot on device WITHOUT touching segment
    files — the checkpoint payload (models/checkpoint.py). `words` is the
    block-compressed postings stream; `flat` the per-block word offsets.
    The expanded arena never lives here:
    it is up to ~10x the compressed words and is rebuilt by one device
    gather at upload."""

    keys: np.ndarray      # (N, W+1) uint32 packed term keys
    words: np.ndarray     # (T,) uint32 compressed postings stream
    flat: np.ndarray      # (B,) int32 per-block word offsets
    tbs: np.ndarray       # (N+1,) int32 term -> first block row
    counts: np.ndarray    # (N,) int32 posting-list lengths
    removed: np.ndarray   # (R,) uint32 sorted tombstones
    slots: np.ndarray     # (S,) int32 linear-probe hash table (-1 empty)
    max_probes: int       # static probe bound of `slots`
    max_count: int        # longest posting list
    width: int            # W (words per packed term, excl. length word)
    max_bw: int           # widest block in words (arena stride - 1)

    @property
    def n_terms(self) -> int:
        return int(self.keys.shape[0])


def _empty_tables(width: int, removed: Optional[np.ndarray] = None) -> HostTables:
    return HostTables(
        keys=np.zeros((0, width + 1), dtype=np.uint32),
        words=np.zeros(0, dtype=np.uint32),
        flat=np.zeros(0, dtype=np.int32),
        tbs=np.zeros(1, dtype=np.int32),
        counts=np.zeros(0, dtype=np.int32),
        removed=(
            np.sort(np.asarray(removed, dtype=np.uint32))
            if removed is not None else np.zeros(0, np.uint32)
        ),
        slots=np.full(8, -1, dtype=np.int32),
        max_probes=1,
        max_count=0,
        width=width,
        max_bw=3,
    )


def build_host_tables(
    blob, offsets, values, voffs, removed=None, width=None, build_hash: bool = True,
) -> HostTables:
    """Lower merged (blob, offsets, values, voffs) arrays to compact host
    tables (the pure-host half of build_snapshot_arrays).

    build_hash=False skips hash-table construction (the mesh stacker builds
    per-device tables at a common size itself — building here too would be
    duplicated O(N) work)."""
    offsets = np.asarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    if n == 0:
        return _empty_tables(width or 1, removed)
    blob_arr = np.frombuffer(blob, dtype=np.uint8) if isinstance(blob, bytes) else blob
    keys = keys_mod.pack_blob(blob_arr, offsets, width)
    W = keys.shape[1] - 1

    # device arena: power-of-two byte widths {0,8,16,32} (static-extraction
    # decode, ops/decode.decode_blocks_ba; the on-disk segment codec keeps
    # exact widths for the compression contract)
    words, outs = packing.encode_bulk(np.asarray(values, dtype=np.uint32), voffs, byte_align=2)
    if len(words) >= 2**31:
        # block offsets travel as int32 (device-friendly); one snapshot
        # partition beyond 8 GiB of packed words must be sharded instead
        raise ValueError("snapshot partition exceeds int32 word addressing; shard it")
    from ..codec import native as native_mod

    counts = words[np.asarray(outs, dtype=np.int64)].astype(np.int64)
    nb1 = np.maximum(-(-counts // 128), 1)
    tbs = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(nb1, out=tbs[1:])
    if native_mod.available():
        flat = native_mod.scan_blocks(words, outs, tbs.astype(np.int64))
    else:
        _, nblocks, block_off, _ = packing.scan_term_blocks(words, outs)
        flat = np.zeros(tbs[-1], dtype=np.int32)
        maxnb = block_off.shape[1]
        colm = np.arange(maxnb, dtype=np.int64)
        maskm = colm[None, :] < nb1[:, None]
        flat[(tbs[:-1].astype(np.int64)[:, None] + colm[None, :])[maskm]] = block_off[maskm]
    # block row arena: stride = largest block + 1 slack word, derived from
    # the block headers directly. Built ON DEVICE from the compressed words
    # (the padded arena is up to ~10x the compressed size — shipping words +
    # offsets and expanding with one device gather beats transferring the
    # expansion).
    headers = words[flat.astype(np.int64)]
    h_b = (headers & 0xFF).astype(np.int64)
    h_nblk = ((headers >> 8) & 0xFF).astype(np.int64)
    blk_words = 2 + packing._packed_words(h_nblk, h_b)
    max_bw = int(blk_words.max()) if len(blk_words) else 3

    rem = np.sort(np.asarray(removed, dtype=np.uint32)) if removed is not None else np.zeros(0, np.uint32)
    if build_hash:
        slots, max_probes = hashing.build_table_with_probes(keys)
    else:
        slots = np.full(8, -1, dtype=np.int32)
        max_probes = 1
    return HostTables(
        keys=keys,
        words=words,
        flat=flat,
        tbs=tbs,
        counts=counts.astype(np.int32),
        removed=rem,
        slots=np.asarray(slots, dtype=np.int32),
        max_probes=max_probes,
        max_count=int(counts.max()) if len(counts) else 0,
        width=W,
        max_bw=max_bw,
    )


def _dev_chunked(a: np.ndarray, chunk_bytes: int) -> jnp.ndarray:
    """Transfer a host array to device in bounded pieces, yielding the GIL
    between pieces. A single jnp.asarray of a large array holds the GIL for
    the WHOLE transfer, starving every other Python thread — during a warm
    checkpoint start that blocks the host-route serving thread for the full
    upload. Bounded pieces bound each hold; the device-side concat is one
    fused copy. Not yet measured on a PCIe-attached card."""
    n = a.shape[0] if a.ndim else 0
    if n == 0 or a.nbytes <= chunk_bytes:
        return jnp.asarray(a)
    step = max(1, int(n * (chunk_bytes / a.nbytes)))
    parts = []
    for c in range(0, n, step):
        parts.append(jnp.asarray(a[c: c + step]))
        # real handoff, not a token one: jnp.asarray holds the GIL for the
        # WHOLE per-chunk transfer (C extension — Python cannot preempt
        # it), so a 1 ms gap lets the serving thread start but stall on
        # its next GIL acquisition behind the following chunk.
        time.sleep(0.01)
    return jnp.concatenate(parts, axis=0)


def upload_tables(
    t: HostTables, chunk_bytes: Optional[int] = None,
) -> IndexSnapshot:
    """Materialize compact host tables on the default device (the upload
    half of build_snapshot_arrays): ship words + offsets, expand the block
    arena with one device gather. The arena is compact: its stride is the
    widest block plus one slack word, and it has one row per block.

    chunk_bytes: transfer the large arrays in pieces of at most this many
    bytes with GIL handoffs between pieces (see _dev_chunked) — set by the
    warm-checkpoint background upload so the host-route serving thread
    stays responsive; None (default) ships each array in one transfer."""
    if t.n_terms == 0:
        snap = _empty_snapshot(t.width or 1)
        snap.removed = jnp.asarray(t.removed)
        return snap
    words, flat = t.words, t.flat
    stride = max(4, t.max_bw + 1)
    _as = ((lambda a: _dev_chunked(np.asarray(a), chunk_bytes))
           if chunk_bytes else jnp.asarray)
    wpad_dev = _as(np.concatenate([words, np.zeros(stride, dtype=np.uint32)]))
    flat_dev = _as(flat)
    arena = _expand_arena(wpad_dev, flat_dev, stride)

    return IndexSnapshot(
        keys=_as(t.keys),
        blocks=jnp.asarray(arena),
        term_block_start=_as(t.tbs),
        counts=_as(t.counts),
        removed=_as(t.removed),
        width=t.width,
        hash_slots=_as(t.slots),
        max_probes=t.max_probes,
        max_count=t.max_count,
        host_counts=t.counts,
    )


def build_snapshot_arrays(
    blob, offsets, values, voffs, removed=None, width=None, build_hash: bool = True,
):
    """Lower merged (blob, offsets, values, voffs) arrays to device tables
    (build_host_tables + upload_tables; see those for the knobs)."""
    return upload_tables(
        build_host_tables(blob, offsets, values, voffs, removed, width, build_hash),
    )


def _collect_removed(index) -> np.ndarray:
    parts = [sh.removed_list.values() for sh in index._snapshot()]
    return np.sort(np.concatenate(parts)) if parts else np.zeros(0, np.uint32)


def _purge_merged(merged, removed: np.ndarray):
    """Apply tombstones to merged (blob, offsets, values, voffs) arrays,
    dropping emptied terms; returns the purged tuple or None if everything
    was removed (the apply_removed=True build semantics)."""
    blob, offsets, values, voffs = merged
    keep = ~np.isin(values, removed, assume_unique=False)
    # recompute per-term counts after the purge; drop empty terms
    term_of = np.repeat(np.arange(len(voffs) - 1), np.diff(voffs))
    values = values[keep]
    term_of = term_of[keep]
    new_counts = np.bincount(term_of, minlength=len(voffs) - 1)
    nz = new_counts > 0
    if not nz.any():
        return None
    lens = np.diff(offsets)[nz]
    starts = offsets[:-1][nz]
    from ..utils.ragged import ragged_gather

    blob_arr = np.frombuffer(blob, dtype=np.uint8) if isinstance(blob, bytes) else blob
    nb, _ = ragged_gather(blob_arr, starts, lens)
    offsets = np.zeros(int(nz.sum()) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    voffs = np.zeros(int(nz.sum()) + 1, dtype=np.int64)
    np.cumsum(new_counts[nz], out=voffs[1:])
    return nb.tobytes(), offsets, values, voffs


def snapshot_new_segments(
    index, base_segments: Dict[str, frozenset], width: Optional[int] = None,
    removed: Optional[np.ndarray] = None, with_tables: bool = False,
):
    """Freeze ONLY the segments not in `base_segments` (shard key ->
    segment-key set): the O(delta) piece of an incremental refresh. Returns
    None when nothing is new. Pass `removed` (sorted tombstones) to purge
    the delta at build — REQUIRED under apply_removed, where the main tier
    was purged and an unpurged delta would resurrect removed values.
    with_tables=True returns (snapshot, HostTables) instead — the engine's
    table-retention mode keeps the compact host half for host-side
    serving (lookup_host) and checkpointing."""
    from ..segment.registry import Segments

    views, pinned_all = [], []
    for sh in index._snapshot():
        pinned = sh.segments.pin_all()
        pinned_all.append(pinned)
        base = base_segments.get(sh.get_key(), frozenset())
        views.extend(
            s.view for s in pinned if s.view is not None and s.key not in base
        )
    try:
        merged = merge_views(views, None)
    finally:
        for pinned in pinned_all:
            Segments.release(pinned)
    if merged is None:
        return None
    if removed is not None and len(removed):
        merged = _purge_merged(merged, removed)
        if merged is None:
            return None
    blob, offsets, values, voffs = merged
    t = build_host_tables(blob, offsets, values, voffs, None, width)
    snap = upload_tables(t)
    return (snap, t) if with_tables else snap


class _SnapshotTier:
    """merge_views-compatible adapter over a DEVICE snapshot: term bytes
    reconstructed from the key matrix, postings device-decoded in
    ladder-grouped batches. Lets two snapshot tiers (main + delta) merge
    into one WITHOUT re-reading any segment file — the promotion path."""

    def __init__(self, snap: IndexSnapshot, engine: "QueryEngine"):
        kb, ko = keys_mod.unpack_keys(np.asarray(snap.keys))
        self.blob = kb
        self.offsets = np.asarray(ko, dtype=np.int64)
        self.n_terms = snap.n_terms
        self.max_term_len = (
            int(np.diff(self.offsets).max()) if snap.n_terms else 0
        )
        self._vals, self._voffs = engine._decode_indices(
            np.arange(snap.n_terms), snap
        )

    def keys(self, W: int) -> np.ndarray:
        return keys_mod.pack_blob(self.blob, self.offsets, W)

    def decode_all(self):
        return self._vals, np.diff(self._voffs), self._voffs


def snapshot_tables(index, apply_removed: bool = False, width: Optional[int] = None) -> HostTables:
    """Freeze an InvertedIndex into compact HOST tables (the pure-host half
    of snapshot_index — also the checkpoint payload, models/checkpoint.py).

    Pins all segments of all shards and merges them logically (global
    sorted terms + unioned values — the same array program as compaction),
    then encodes postings with the block codec. Equivalent read semantics
    to Read(nil, nil)."""
    from ..segment.registry import Segments

    views, pinned_all, removed_parts = [], [], []
    for sh in index._snapshot():
        pinned = sh.segments.pin_all()
        pinned_all.append(pinned)
        views.extend(s.view for s in pinned if s.view is not None)
        removed_parts.append(sh.removed_list.values())
    try:
        merged = merge_views(views, None)
    finally:
        for pinned in pinned_all:
            Segments.release(pinned)
    removed = (
        np.sort(np.concatenate(removed_parts)) if removed_parts else np.zeros(0, np.uint32)
    )
    if merged is None:
        return _empty_tables(width or 1, removed)
    if apply_removed and len(removed):
        merged = _purge_merged(merged, removed)
        if merged is None:
            return _empty_tables(width or 1)
        removed = np.zeros(0, np.uint32)
    blob, offsets, values, voffs = merged
    return build_host_tables(blob, offsets, values, voffs, removed, width)


def snapshot_index(index, apply_removed: bool = False, width: Optional[int] = None) -> IndexSnapshot:
    """Freeze an InvertedIndex into a device snapshot (snapshot_tables +
    upload_tables)."""
    return upload_tables(snapshot_tables(index, apply_removed=apply_removed, width=width))



def _index_fingerprint(index, apply_removed: bool):
    """Cheap identity of the index's visible state (segment keys + tombstone
    batch counts per shard) for refresh no-op detection. Tombstone counts are
    ALWAYS part of the identity: even without apply_removed they feed the
    engine's filter_removed array, so a tombstone-only change must refresh."""
    parts = []
    for sh in index._snapshot():
        segs = tuple(s.key for s in sh.segments.snapshot())
        parts.append((sh.get_key(), segs, len(sh.removed_list)))
    return (apply_removed, tuple(parts))

