"""Jitted serving steps (pure functions of snapshot arrays), the result
wire codec, and small shared helpers (padding, ladders, columnar utils).

Split out of models/query_engine.py (which re-exports every name here, so
external imports are unchanged).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..codec import hashing
from ..ops import decode as dec
from ..ops import dict_search as ds
from ..ops import setops
from .snapshot import IndexSnapshot


# ---------------------------------------------------------------------------
# jitted forward steps (pure functions of snapshot arrays)
# ---------------------------------------------------------------------------


def _resolve(keys, qkeys, slots=None, max_probes: int = 0):
    """Exact term -> index resolution: hash probe when a table is provided
    (2-4 gathers), else multiword binary search (log2 N gathers)."""
    if slots is not None:
        return ds.hash_lookup_rows(keys, slots, qkeys, max_probes)
    return ds.lookup_rows(keys, qkeys)


def lookup_step(
    keys, blocks, term_block_start, counts, qkeys, L: int,
    slots=None, max_probes: int = 0, removed=None,
):
    """Batched exact-term lookup:
    (found (Q,), postings (Q, L), counts (Q,), raw_counts (Q,)).

    One fused program: hash probe (or binary search) -> block row gather ->
    static byte-unpack decode. Misses return count 0. Pass `removed` (sorted)
    to apply the vectorized tombstone filter to each result row.

    raw_counts is the term's TRUE posting count: raw > L means the row holds
    only the first L postings and the caller must re-serve that query at a
    larger L for exactness (QueryEngine does this automatically; the
    reference streams runs of any length, reader.go:79-98 — here exactness
    costs one extra pass at the next static size instead).
    """
    idx, found = _resolve(keys, qkeys, slots, max_probes)
    vals, raw = dec.gather_postings_arena(blocks, term_block_start, counts, idx, L)
    raw = jnp.where(found, raw, 0)
    n = jnp.minimum(raw, L)
    if removed is not None and removed.shape[0] > 0:
        vals, n = setops.filter_removed(vals, n, removed)
    return found, vals, n, raw


def boolean_step(
    keys, blocks, term_block_start, counts,
    qkeys, k_valid, L: int, op: str, removed=None,
    slots=None, max_probes: int = 0,
):
    """Batched boolean query: qkeys (Q, K, W+1), k_valid (Q,).

    AND: missing/absent term => empty result. OR: misses contribute nothing.
    Optional vectorized tombstone filtering of the combined result.
    """
    Q, K, Wp1 = qkeys.shape
    flat = qkeys.reshape(Q * K, Wp1)
    idx, found = _resolve(keys, flat, slots, max_probes)
    vals, raw = dec.gather_postings_arena(blocks, term_block_start, counts, idx, L)
    # need: the largest TRUE posting count among a query's present terms.
    # need > L means some list was clipped at decode, so the combined result
    # may be incomplete — callers re-serve those (rare) queries at the next
    # ladder L (device-exact; no host fallback).
    raw = jnp.where(found, raw, 0)
    n = jnp.minimum(raw, L)
    lists = vals.reshape(Q, K, L)
    ncnt = n.reshape(Q, K)
    kmask = jnp.arange(K, dtype=jnp.int32)[None, :] < k_valid[:, None]
    need = jnp.max(
        jnp.where(kmask, raw.reshape(Q, K), 0), axis=1
    ).astype(jnp.int32)
    if op == "and":
        out, oc = setops.intersect_many(lists, ncnt, k_valid)
    elif op == "or":
        out, oc = setops.union_many(lists, ncnt, k_valid)
    else:
        raise ValueError(op)
    if removed is not None and removed.shape[0] > 0:
        out, oc = setops.filter_removed(out, oc, removed)
    return out, oc, need


def boolean_step_dual(
    keys1, blocks1, tbs1, counts1, slots1,
    keys2, blocks2, tbs2, counts2, slots2,
    qkeys1, qkeys2, k_valid, L: int, op: str, removed=None,
    max_probes1: int = 0, max_probes2: int = 0,
):
    """boolean_step over a MAIN + DELTA snapshot pair (incremental refresh):
    each term's postings are the union of its rows in both snapshots (a term
    may live in both — same union semantics as the reference's k-way read
    across segments, types.go:14-22), then the set op runs on the combined
    (Q, K, 2L) lists. Returns (out (Q, 2L), oc, need) — need sums both
    snapshots' raw counts, so callers re-serve at a ladder level covering
    the union."""
    Q, K, Wp1 = qkeys1.shape
    flat1 = qkeys1.reshape(Q * K, Wp1)
    flat2 = qkeys2.reshape(Q * K, qkeys2.shape[-1])
    idx1, f1 = _resolve(keys1, flat1, slots1, max_probes1)
    v1, r1 = dec.gather_postings_arena(blocks1, tbs1, counts1, idx1, L)
    r1 = jnp.where(f1, r1, 0)
    idx2, f2 = _resolve(keys2, flat2, slots2, max_probes2)
    v2, r2 = dec.gather_postings_arena(blocks2, tbs2, counts2, idx2, L)
    r2 = jnp.where(f2, r2, 0)
    pair = jnp.stack([v1, v2], axis=1)                        # (QK, 2, L)
    pcnt = jnp.stack([jnp.minimum(r1, L), jnp.minimum(r2, L)], axis=1)
    u, uc = setops.union_many(pair, pcnt, jnp.full((Q * K,), 2, jnp.int32))
    lists = u.reshape(Q, K, 2 * L)
    ncnt = uc.reshape(Q, K)
    kmask = jnp.arange(K, dtype=jnp.int32)[None, :] < k_valid[:, None]
    need = jnp.max(
        jnp.where(kmask, (r1 + r2).reshape(Q, K), 0), axis=1
    ).astype(jnp.int32)
    if op == "and":
        out, oc = setops.intersect_many(lists, ncnt, k_valid)
    elif op == "or":
        out, oc = setops.union_many(lists, ncnt, k_valid)
    else:
        raise ValueError(op)
    if removed is not None and removed.shape[0] > 0:
        out, oc = setops.filter_removed(out, oc, removed)
    return out, oc, need


def prefix_range_step(keys, lo_keys, hi_keys):
    """Device prefix -> dictionary range [lo, hi) (PrefixSearch kernel).

    hi_keys must be the 0xff-saturated prefix key with length word 0xFFFFFFFF
    (strictly greater than every term sharing the prefix)."""
    lo = ds.searchsorted_rows(keys, lo_keys)
    hi = ds.searchsorted_rows(keys, hi_keys)
    return lo, hi


# ---------------------------------------------------------------------------
# host-facing engine
# ---------------------------------------------------------------------------

_JIT_LOOKUP = jax.jit(lookup_step, static_argnames=("L", "max_probes"))
_JIT_BOOLEAN = jax.jit(boolean_step, static_argnames=("L", "op", "max_probes"))
_JIT_BOOLEAN_DUAL = jax.jit(
    boolean_step_dual, static_argnames=("L", "op", "max_probes1", "max_probes2")
)
_JIT_PREFIX = jax.jit(prefix_range_step)
_JIT_DECODE = jax.jit(dec.gather_postings_arena, static_argnames=("L",))

from ..ops import concat_bool as _cb

_JIT_RESOLVE = jax.jit(_cb.resolve_step, static_argnames=("max_probes",))


def _resolve_sb_step(keys, counts, qkeys, slots=None, max_probes: int = 0):
    """resolve_step + the per-query total-BLOCK sum the stream's class
    grouping needs, reduced ON DEVICE: the (Q, K) raw-count matrix is
    256 KB/8192-query batch of fetch the host would only ever sum."""
    idx, found, raw = _cb.resolve_step(keys, counts, qkeys, slots, max_probes)
    nb = -(-raw.astype(jnp.int32) // 128)  # i32: counts are i32 already
    return idx, found, jnp.sum(nb, axis=1).astype(jnp.int32)


_JIT_RESOLVE_SB = jax.jit(_resolve_sb_step, static_argnames=("max_probes",))


def _host_resolve_sb(tables, qk: np.ndarray):
    """The host twin of _resolve_sb_step for engines with retained tables:
    probe the HOST hash table (codec/hashing.probe_rows_np — same probe
    sequence, same full-key verification as the device resolve) and derive
    the per-query block sums there. The stream's class grouping needs the
    block sums ON HOST anyway, so resolving host-side removes both the
    (Q, K, W+1) qkey upload (the signed idx rows ship instead — 4x fewer
    bytes at W=3) and the BLOCKING (Q,) fetch from the dispatch path,
    which serializes every later dispatch behind it. The postings
    decode/sort/page compute stays on device — this moves only the
    dictionary probe, the half the reference also runs in host code
    (vellum FST, segment.go:55-70).

    Returns (idx_signed (Q, K) i32 with -1 = miss, cnt (Q, K) i64 true
    counts, sb (Q,) i64 per-query total blocks)."""
    Qb, K = qk.shape[0], qk.shape[1]
    idx = hashing.probe_rows_np(
        tables.slots, tables.max_probes, tables.keys,
        _narrow_keys(qk.reshape(Qb * K, -1), tables.width),
    ).reshape(Qb, K).astype(np.int32)
    cnt = np.where(
        idx >= 0, tables.counts[np.maximum(idx, 0)].astype(np.int64), 0
    )
    sb = (-(-cnt // 128)).sum(axis=1)
    return idx, cnt, sb


def _split_idx_step(idx_signed):
    """Host-resolved signed term rows -> the (idx, found) device pair the
    concat/sel steps consume (one tiny dispatch replaces the device
    resolve pass when _host_resolve_sb ran)."""
    return jnp.maximum(idx_signed, 0), idx_signed >= 0


_JIT_SPLIT_IDX = jax.jit(_split_idx_step)


def _concat_bool_sel_step(blocks, tbs, counts, idx_full, found_full,
                          kv_full, sel, SB: int, op: str,
                          prefix_p: int = 0, wire_dedup: bool = False):
    """boolean_concat_step over a SELECTION of an on-device resolve batch:
    `sel` (B,) i32 rows of idx_full/found_full/kv_full (-1 = pad). The
    stream's class chunks ship this 4 B/row selector instead of gathering
    the rows on HOST and re-uploading (B, K) matrices per chunk (~150 KB
    and a device_put each)."""
    valid = sel >= 0
    s2 = jnp.maximum(sel, 0)
    idx = idx_full[s2]
    found = found_full[s2] & valid[:, None]
    kv = jnp.where(valid, kv_full[s2], 0)
    return _cb.boolean_concat_step(
        blocks, tbs, counts, idx, found, kv, SB, op,
        prefix_p=prefix_p, wire_dedup=wire_dedup,
    )


_JIT_CONCAT_BOOL_SEL = jax.jit(
    _concat_bool_sel_step,
    static_argnames=("SB", "op", "prefix_p", "wire_dedup"),
)


def _scatter_p_step(obuf, sel, o, oc):
    """Accumulate one class chunk's P-slice into the batch's SINGLE result
    buffer: obuf (QB, P+1) u32 — columns [0, P) the first-P values, column
    P the query's true count — with `sel` (B,) i32 the destination rows
    (-1 = pad). Pads are remapped to QB — a genuinely out-of-bounds row —
    BEFORE the scatter: JAX normalizes negative indices (-1 → QB-1) ahead
    of mode="drop", so a raw -1 pad would overwrite the LAST query's row
    with an empty pad result whenever a later-dispatched class chunk is
    padded (hit end-to-end when nq is an exact multiple of q_bucket —
    tests/test_query_engine.py::test_staged_prefix_pagination_full_bucket).
    This is the pagination stream's fetch-coalescing trick: every fetched
    array pays a transfer latency regardless of size, so the harvest
    fetches exactly ONE array per batch. Donated buffer: each chunk's
    scatter reuses the allocation; the chain serializes on device (the
    chunks already run in dispatch order on one stream)."""
    P = obuf.shape[1] - 1
    if o.shape[1] >= P:
        o2 = o[:, :P]
    else:
        o2 = jnp.pad(o, ((0, 0), (0, P - o.shape[1])))
    row = jnp.concatenate(
        [o2.astype(obuf.dtype), oc.astype(obuf.dtype)[:, None]], axis=1)
    sel_oob = jnp.where(sel >= 0, sel, obuf.shape[0])
    return obuf.at[sel_oob].set(row, mode="drop")


_JIT_SCATTER_P = jax.jit(_scatter_p_step, donate_argnums=(0,))


def _pack_p_step(obuf):
    """u16 delta-pack of one batch's pagination buffer, dispatched at
    class-stage time (STATIC width — a data-dependent-width pack must wait
    for the counts fetch and serializes the pipeline). Pages are sorted
    unique values, so consecutive deltas are small; the whole batch ships as ONE
    (QB, P+3) u16 plane — ~1.8x fewer bytes than the raw u32 buffer on a
    bandwidth-bound link:

      cols [0, P-1): value deltas, truncated to u16 (invalid lanes zeroed)
      col P-1, P:    first value lo/hi
      col P+1, P+2:  true count lo / hi, with bit 15 of hi = OVERFLOW flag
                     (some kept delta >= 2^16; the harvest re-fetches those
                     rows raw from the still-resident buffer — rare, but
                     terms over a wide doc space can hit it)

    Count hi bit 15 is free: counts are non-negative i32."""
    P = obuf.shape[1] - 1
    vals = obuf[:, :P]
    cnt = obuf[:, P]
    kept = jnp.minimum(cnt, jnp.uint32(P)).astype(jnp.int32)
    d = vals[:, 1:] - vals[:, :-1]
    j = jnp.arange(P - 1, dtype=jnp.int32)[None, :]
    dvalid = j < (kept - 1)[:, None]
    d = jnp.where(dvalid, d, 0)
    flag = jnp.any(d >= jnp.uint32(1 << 16), axis=1)
    first = vals[:, 0]

    def u16(x):
        return x.astype(jnp.uint16)

    return jnp.concatenate(
        [
            u16(d),
            u16(first & 0xFFFF)[:, None], u16(first >> 16)[:, None],
            u16(cnt & 0xFFFF)[:, None],
            u16((cnt >> 16) | (flag.astype(jnp.uint32) << 15))[:, None],
        ],
        axis=1,
    )


_JIT_PACK_P = jax.jit(_pack_p_step)
_JIT_TAKE_ROWS = jax.jit(lambda a, i: a[i])
_JIT_CONCAT_BOOL = jax.jit(
    _cb.boolean_concat_step,
    static_argnames=("SB", "op", "compactor", "prefix_p", "wire_dedup"),
)
_JIT_FILTER = jax.jit(setops.filter_removed)


# -- result wire codec (full-result fetch compression) -----------------------
#
# Full-result set ops ship O(sum of posting lengths) back to the host; on a
# bandwidth-bound link the fetch IS the serving floor. Result rows are
# sorted, so their deltas are small: shipping (first value u32, deltas u8 or
# u16) halves/quarters the wire volume, and the host reconstructs with one
# vectorized cumsum. The dtype is chosen PER DISPATCH from the masked max
# delta (computed on device at dispatch time, fetched with the counts — no
# extra round trip vs the trim path it replaces); a dispatch whose max delta
# exceeds 16 bits falls back to the raw u32 trim. Exact for any corpus.


def _wire_meta_step(o, oc):
    """Masked max result delta of a dispatch (deltas past a row's count are
    pad garbage and must not inflate the width choice)."""
    d = o[:, 1:] - o[:, :-1]
    col = jnp.arange(o.shape[1] - 1, dtype=jnp.int32)
    mask = col[None, :] < (oc[:, None] - 1)
    return jnp.max(jnp.where(mask, d, 0), initial=jnp.uint32(0))


def _wire_pack_step(o, bits: int):
    """(first column u32, delta plane u8/u16). Deltas past a row's count may
    wrap — the host trims to the row count before they are ever read."""
    dt = jnp.uint8 if bits == 8 else jnp.uint16
    return o[:, :1], (o[:, 1:] - o[:, :-1]).astype(dt)


_JIT_WIRE_META = jax.jit(_wire_meta_step)
_JIT_WIRE_PACK = jax.jit(_wire_pack_step, static_argnames=("bits",))


def _wire_unpack(first: np.ndarray, deltas: np.ndarray) -> np.ndarray:
    """Host half: reconstruct the (B, maxc) u32 result matrix."""
    out = np.empty((first.shape[0], 1 + deltas.shape[1]), dtype=np.uint32)
    out[:, :1] = first
    out[:, 1:] = deltas
    return np.cumsum(out, axis=1, dtype=np.uint32)


def _dedup_adjacent(v: np.ndarray) -> np.ndarray:
    """Drop adjacent duplicates from one sorted row — the host half of the
    wire-dedup OR contract (concat_bool.boolean_concat_step wire_dedup):
    result sets are sorted UNIQUE, so a repeated value can only be a
    cross-list duplicate the device deliberately left in the stream to
    skip its compaction sort."""
    if len(v) < 2:
        return v
    m = np.empty(len(v), dtype=bool)
    m[0] = True
    np.not_equal(v[1:], v[:-1], out=m[1:])
    return v[m]



def _round_up(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


def _batch_as_lists(b):
    """Normalize one stream batch to a list of term lists (identity for
    list input; expands a columnar (blob, offsets, qoffs) triple — the
    slow-path inverse of QueryEngine._pack_boolean_cols, used only by the
    per-batch fallbacks)."""
    if not (isinstance(b, tuple) and len(b) == 3):
        return b
    blob, offsets, qoffs = b
    blob8 = (
        np.frombuffer(blob, dtype=np.uint8)
        if isinstance(blob, (bytes, bytearray))
        else np.asarray(blob, dtype=np.uint8)
    )
    offsets = np.asarray(offsets, dtype=np.int64)
    terms = [
        blob8[offsets[i] : offsets[i + 1]].tobytes()
        for i in range(len(offsets) - 1)
    ]
    return [
        terms[int(qoffs[i]) : int(qoffs[i + 1])]
        for i in range(len(qoffs) - 1)
    ]


def _rows_to_columnar(rows):
    """List-of-arrays -> (values, voffs[n+1]) columnar pair."""
    counts = np.array(
        [0 if r is None else len(r) for r in rows], dtype=np.int64
    )
    voffs = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(counts, out=voffs[1:])
    vals = (
        np.concatenate([r for r in rows if r is not None and len(r)])
        if voffs[-1] else np.zeros(0, np.uint32)
    ).astype(np.uint32)
    return vals, voffs


def _narrow_keys(qk: np.ndarray, to_width: int) -> np.ndarray:
    """Drop trailing key words down to `to_width` (keeping the length word).

    Always safe toward a snapshot whose corpus fits `to_width`: a term
    longer than to_width*4 bytes cannot exist there, and the preserved
    length word keeps equality exact for everything else. (The inverse —
    widening a key that was packed too narrow — would zero-fill bytes the
    other tier has, producing false negatives; queries must be PACKED at
    the maximum width across tiers and narrowed per tier.)"""
    W = qk.shape[-1] - 1
    if W == to_width:
        return qk
    assert W > to_width
    return np.concatenate([qk[..., :to_width], qk[..., -1:]], axis=-1)


# device-memory budget for one re-serve batch (uint32 elements): bounds the
# (Q, L') result matrices when re-serving long-posting queries exactly
_RESERVE_BUDGET = 1 << 24  # 64 MiB of uint32


def _ladder(L: int, max_count: int, step: int = 4) -> List[int]:
    """Static L sizes for exact re-serves: L, 4L, 16L, ... capped at the
    corpus' longest posting list (rounded up to a block multiple). A handful
    of levels => a handful of compiled programs, each reused (levels compile
    lazily — only sizes a workload actually hits). Step 4 balances re-serve
    cost (a clipped query pays ~step/2 x the base pass) against program
    count; heavy-tailed corpora hit 2-3 levels in practice."""
    levels = []
    cur = L
    top = _round_up(max_count, 128)
    while cur < top:
        cur = min(cur * step, top)
        levels.append(cur)
    return levels

