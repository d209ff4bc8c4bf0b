"""Sorted-set operations over padded posting matrices (device).

The reference unions posting lists pairwise inside its k-way merging iterator
(MergeTermValues, /root/reference/file/types.go:14-22) and filters tombstones
by per-value binary search (/root/reference/shard.go:181-190). Here posting
lists are rows of fixed-shape (Q, L) uint32 matrices with per-row counts, and
AND/OR/tombstone-filter are batched array programs:

 * intersect_many / union_many: boolean AND / OR of K lists per query
   (BASELINE config 3: 2-8 terms, mean posting length 1k)
 * filter_removed: vectorized sorted-membership mask

Padding convention: rows are valid in [0, count); garbage beyond. Compaction
to the front uses a single sort per op (padding slots forced to SENTINEL=max
then counted out). Values equal to 0xFFFFFFFF remain correct: counts, not
sentinels, define validity.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# np scalar, NOT jnp: a module-level jnp.uint32 is a concrete device
# array; traces that close over it hoist it into an EXECUTABLE PARAMETER,
# and jax 0.9's C++ jit fast path drops such hoisted consts on the second
# same-signature call under a multi-device CPU platform ("Execution
# supplied N buffers but compiled program expected N+k"). A numpy scalar
# embeds as a jaxpr literal instead — no extra parameter, no bug.
SENTINEL = np.uint32(0xFFFFFFFF)


def _valid_mask(L: int, counts: jnp.ndarray) -> jnp.ndarray:
    return jnp.arange(L, dtype=jnp.int32)[None, :] < counts[:, None]


def _batched_searchsorted(haystack: jnp.ndarray, needles: jnp.ndarray) -> jnp.ndarray:
    """Row-wise searchsorted: haystack (Q, L) sorted rows, needles (Q, P)."""
    return jax.vmap(lambda h, x: jnp.searchsorted(h, x))(haystack, needles)


# up to this probe-matrix volume the O(P*L) broadcast compare is used;
# above it, the batched binary search / sort formulations
_BROADCAST_LIMIT = 512 * 512


def member_mask(
    lists: jnp.ndarray, counts: jnp.ndarray, probes: jnp.ndarray
) -> jnp.ndarray:
    """For each row: is probes[q, j] a member of lists[q, :counts[q]]?

    lists rows must be sorted ascending within [0, count). For small rows the
    membership test is a broadcast equality reduction — pure elementwise
    compares, no dynamic gathers. Larger rows fall back to a batched binary
    search.
    """
    L = lists.shape[1]
    P = probes.shape[1]
    if P * L <= _BROADCAST_LIMIT:
        vm = _valid_mask(L, counts)  # (Q, L)
        eq = probes[:, :, None] == lists[:, None, :]  # (Q, P, L)
        return jnp.any(eq & vm[:, None, :], axis=-1)
    clean = jnp.where(_valid_mask(L, counts), lists, SENTINEL)
    clean = jnp.sort(clean, axis=1)
    pos = _batched_searchsorted(clean, probes)
    pos_c = jnp.minimum(pos, L - 1)
    hit = jnp.take_along_axis(clean, pos_c, axis=1) == probes
    return hit & (pos < counts[:, None])


def intersect_many(
    lists: jnp.ndarray, counts: jnp.ndarray, k_valid: jnp.ndarray
):
    """Boolean AND of K sorted lists per query.

    lists: (Q, K, L) sorted rows; counts: (Q, K); k_valid: (Q,) number of
    lists actually present per query (queries may have 2..K terms).
    Returns (vals (Q, L) compacted ascending, out_counts (Q,)).
    Empty/missing required list => empty result (AND semantics).

    Two regimes: small rows use broadcast membership against the base list
    (pure elementwise compares); large rows use a SORT-based run-length
    intersection (one sort of the K*L concat) instead of a gather-bound
    batched binary search (chosen on another accelerator; not yet measured
    on the GPU).
    """
    Q, K, L = lists.shape
    if L * L > _BROADCAST_LIMIT:
        return _intersect_sort(lists, counts, k_valid)
    base = lists[:, 0, :]
    base_n = counts[:, 0]
    keep = _valid_mask(L, base_n)
    for j in range(1, K):
        active = (j < k_valid)[:, None]
        hit = member_mask(lists[:, j, :], counts[:, j], base)
        keep &= jnp.where(active, hit, True)
    # count first, then compact (ties with genuine SENTINEL values are safe:
    # they land last and the count keeps them)
    from .compaction import compact_rows

    out_counts = jnp.sum(keep, axis=1).astype(jnp.int32)
    return compact_rows(base, keep), out_counts


def _intersect_sort(lists: jnp.ndarray, counts: jnp.ndarray, k_valid: jnp.ndarray):
    """Sort-based AND: concat the K lists, sort, keep values whose run
    length equals k_valid (values are unique within a list, so a value
    appears exactly as many times as lists containing it — never more than
    k_valid, since slots past k_valid are masked out).

    Returns (vals (Q, L) compacted ascending, out_counts (Q,)) — the result
    of an AND fits in L (it is a subset of every input list).
    """
    Q, K, L = lists.shape
    kmask = jnp.arange(K, dtype=jnp.int32)[None, :, None] < k_valid[:, None, None]
    vmask = jnp.arange(L, dtype=jnp.int32)[None, None, :] < counts[:, :, None]
    valid = (kmask & vmask).reshape(Q, K * L)
    flat = jnp.where(valid, lists.reshape(Q, K * L), SENTINEL)
    svals = jnp.sort(flat, axis=1)
    first = jnp.concatenate(
        [jnp.ones((Q, 1), dtype=bool), svals[:, 1:] != svals[:, :-1]], axis=1
    )
    # run reaches k_valid <=> svals[i] == svals[i + k_valid - 1]; k_valid is
    # dynamic but K is tiny, so select among K static shifts (no gathers;
    # shared with the concat-decode formulation)
    from .concat_bool import run_reaches_k

    keep = run_reaches_k(svals, k_valid, K) & first & (svals != SENTINEL)
    # a GENUINE 0xFFFFFFFF present in every valid list: its run merges with
    # the padding sentinels, so test it separately via each list's last slot
    last = jnp.take_along_axis(
        lists, jnp.maximum(counts - 1, 0)[:, :, None], axis=2
    )[:, :, 0]
    has_ff = (counts > 0) & (last == SENTINEL)
    ff_all = jnp.all(has_ff | ~kmask[:, :, 0], axis=1) & (k_valid > 0)
    out_counts = (jnp.sum(keep, axis=1) + ff_all.astype(jnp.int32)).astype(jnp.int32)
    # compact kept run-starts to the front; slot [count-1] for a kept genuine
    # 0xFFFFFFFF is already SENTINEL from padding (bit-identical, same trick
    # as union_many). Result size <= L, so narrow to L after compaction.
    from .compaction import compact_rows

    return compact_rows(svals, keep)[:, :L], out_counts


def union_many(lists: jnp.ndarray, counts: jnp.ndarray, k_valid: jnp.ndarray):
    """Boolean OR of K sorted lists per query.

    Returns (vals (Q, K*L) compacted ascending unique, out_counts (Q,)).
    """
    Q, K, L = lists.shape
    kmask = jnp.arange(K, dtype=jnp.int32)[None, :, None] < k_valid[:, None, None]
    vmask = jnp.arange(L, dtype=jnp.int32)[None, None, :] < counts[:, :, None]
    valid = (kmask & vmask).reshape(Q, K * L)
    flat = jnp.where(valid, lists.reshape(Q, K * L), SENTINEL)
    n_valid = jnp.sum(valid, axis=1).astype(jnp.int32)
    # Sort: invalid slots (== SENTINEL) land last. A genuine 0xFFFFFFFF value
    # is bit-identical to the sentinel, so any at the validity boundary are
    # interchangeable — the first n_valid slots always hold exactly the valid
    # multiset. No 64-bit tagging needed.
    vals = jnp.sort(flat, axis=1)
    in_region = jnp.arange(K * L, dtype=jnp.int32)[None, :] < n_valid[:, None]
    first = jnp.concatenate(
        [jnp.ones((Q, 1), dtype=bool), vals[:, 1:] != vals[:, :-1]], axis=1
    )
    uniq = in_region & first
    out_counts = jnp.sum(uniq, axis=1).astype(jnp.int32)
    # compact unique values to the front (duplicates -> SENTINEL, which
    # lands after all kept values; a kept genuine 0xFFFFFFFF is
    # interchangeable with padding at the count boundary); see
    # ops/compaction.py for the formulation compact_rows uses.
    from .compaction import compact_rows

    return compact_rows(vals, uniq), out_counts


def filter_removed(
    vals: jnp.ndarray, counts: jnp.ndarray, removed: jnp.ndarray
):
    """Drop tombstoned values from each sorted row; compact to front.

    removed: (R,) sorted uint32 (may be empty). The reference's per-value
    slices.BinarySearch (/root/reference/shard.go:183-190) becomes one
    vectorized searchsorted over the whole batch.
    Returns (vals, counts) with survivors ascending.
    """
    Q, L = vals.shape
    R = removed.shape[0]
    valid = _valid_mask(L, counts)
    if R == 0:
        return vals, counts
    pos = jnp.searchsorted(removed, vals.reshape(-1)).reshape(Q, L)
    hit = removed[jnp.minimum(pos, R - 1)] == vals
    hit &= pos < R
    keep = valid & ~hit
    # compact survivors to the front: dropped slots -> SENTINEL. Genuine
    # 0xFFFFFFFF survivors are interchangeable with padding at the count
    # boundary (same bits), so [0, out_count) is exactly the survivors.
    from .compaction import compact_rows

    out_counts = jnp.sum(keep, axis=1).astype(jnp.int32)
    return compact_rows(vals, keep), out_counts
