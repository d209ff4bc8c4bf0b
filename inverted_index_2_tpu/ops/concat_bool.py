"""Concat-decode boolean queries: work proportional to REAL posting data.

The padded formulation (boolean_step: decode each of K terms to a fixed
(Q, K, L) matrix, then set-op) pays K*L_pad per query, where L_pad must
cover the LONGEST list — brutal for heavy-tailed corpora (BASELINE config 3,
mean posting length 1k): most of the sorted volume is padding, and clipped
queries re-serve at an even larger pad.

This formulation sizes each query by its TOTAL posting count instead:

  1. resolve_step (cheap, no decode): term -> dictionary index + raw counts
  2. the host groups queries into total-BLOCK classes SB (few static shapes)
  3. boolean_concat_step: each query's block rows — CONSECUTIVE per term in
     the arena — are laid out contiguously into (Q, SB) slots (term-of-slot
     resolved by a K-step static select, no gathers), decoded in one row
     gather, masked to real lanes, sorted ONCE at (Q, SB*128), and reduced
     by run length: a value appears exactly as many times as lists that
     contain it (lists are sorted-unique), so
        AND: run length == k_valid      OR: first of run
     (the same trick as setops._intersect_sort, over concat instead of pad).

Exactness is unconditional — there is no truncation and no re-serve; a
query whose lists total 5k postings sorts ~5k+slack values regardless of
its longest list. Genuine 0xFFFFFFFF members are handled like
setops.union_many (they are bit-identical to padding at the count boundary).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

BLOCK = 128
# np scalar, NOT jnp: a module-level jnp.uint32 is a concrete device
# array; traces that close over it hoist it into an EXECUTABLE PARAMETER,
# and jax 0.9's C++ jit fast path drops such hoisted consts on the second
# same-signature call under a multi-device CPU platform ("Execution
# supplied N buffers but compiled program expected N+k"). A numpy scalar
# embeds as a jaxpr literal instead — no extra parameter, no bug.
SENTINEL = np.uint32(0xFFFFFFFF)


def resolve_step(keys, counts, qkeys, slots=None, max_probes: int = 0):
    """Batched term resolution only: (idx (Q,K), found (Q,K), raw (Q,K)).

    qkeys: (Q, K, W+1). No posting decode — this is the cheap first pass
    whose raw counts let the host pick each query's size class."""
    from . import dict_search as ds

    Q, K, Wp1 = qkeys.shape
    flat = qkeys.reshape(Q * K, Wp1)
    if slots is not None:
        idx, found = ds.hash_lookup_rows(keys, slots, flat, max_probes)
    else:
        idx, found = ds.lookup_rows(keys, flat)
    raw = jnp.where(found, counts[idx], 0)
    return idx.reshape(Q, K), found.reshape(Q, K), raw.reshape(Q, K)


def concat_layout(tbs_q, cnt, SB: int):
    """Slot assignment for the contiguous per-query block layout.

    tbs_q: (Q, K) first arena row per term; cnt: (Q, K) raw counts (already
    masked to live terms). Returns (rows, in_use, bit, cnt_j, cum):
    rows (Q, SB) arena row per slot, in_use (Q, SB), bit = block index
    within its term, cnt_j = owning term's count, cum (Q, K+1) block prefix
    sums. Term-of-slot resolves with K-step static selects — no gathers."""
    Q, K = tbs_q.shape
    nb = (cnt + BLOCK - 1) // BLOCK
    cum = jnp.concatenate(
        [jnp.zeros((Q, 1), jnp.int32), jnp.cumsum(nb, axis=1, dtype=jnp.int32)],
        axis=1,
    )
    s_idx = jnp.arange(SB, dtype=jnp.int32)[None, :]
    j_of = jnp.zeros((Q, SB), jnp.int32)
    for k in range(1, K):
        j_of = j_of + (s_idx >= cum[:, k : k + 1]).astype(jnp.int32)
    cum_j = jnp.zeros((Q, SB), jnp.int32)
    tbs_j = jnp.zeros((Q, SB), jnp.int32)
    cnt_j = jnp.zeros((Q, SB), jnp.int32)
    for k in range(K):
        sel = j_of == k
        cum_j = jnp.where(sel, cum[:, k : k + 1], cum_j)
        tbs_j = jnp.where(sel, tbs_q[:, k : k + 1], tbs_j)
        cnt_j = jnp.where(sel, cnt[:, k : k + 1], cnt_j)
    in_use = s_idx < cum[:, K:]
    bit = s_idx - cum_j
    rows = jnp.where(in_use, tbs_j + bit, 0)
    return rows, in_use, bit, cnt_j, cum


def decode_masked(blocks, rows, in_use, bit, cnt_j):
    """Decode the laid-out blocks and mask real lanes -> (Q, SB*128) flat
    values (invalid slots/lanes = SENTINEL) plus the raw decoded matrix."""
    from .decode import decode_blocks_ba

    Q, SB = rows.shape
    vals, _ = decode_blocks_ba(blocks[rows])          # (Q, SB, 128)
    lanes = jnp.arange(BLOCK, dtype=jnp.int32)[None, None, :]
    vl = jnp.clip(cnt_j - bit * BLOCK, 0, BLOCK)
    mask = in_use[..., None] & (lanes < vl[..., None])
    flat = jnp.where(mask, vals, SENTINEL).reshape(Q, SB * BLOCK)
    return flat, vals, mask


def run_reaches_k(svals, k_valid, K: int):
    """run length >= k_valid at each position: svals[i] == svals[i+kv-1],
    selected among K static shifts (values unique per list, so run length
    can never exceed k_valid — equality follows)."""
    Q, S = svals.shape
    keep = jnp.zeros((Q, S), dtype=bool)
    for j in range(K):
        shifted = (
            svals
            if j == 0
            else jnp.concatenate(
                [svals[:, j:], jnp.full((Q, j), SENTINEL, dtype=svals.dtype)],
                axis=1,
            )
        )
        keep = jnp.where((k_valid == j + 1)[:, None], shifted == svals, keep)
    return keep


def last_values(vals, cum, cnt):
    """Each term's LAST posting value from the decoded matrix (for the
    genuine-0xFFFFFFFF membership test): (Q, K)."""
    Q = cnt.shape[0]
    S = vals.shape[1] * BLOCK
    last_slot = jnp.maximum(cum[:, 1:] - 1, 0)
    last_lane = jnp.maximum((cnt - 1) % BLOCK, 0)
    return jnp.take_along_axis(
        vals.reshape(Q, S),
        (last_slot * BLOCK + last_lane).astype(jnp.int32),
        axis=1,
    )


def boolean_concat_step(
    blocks, term_block_start, counts,
    idx, found, k_valid, SB: int, op: str, compactor: str = "auto",
    prefix_p: int = 0, wire_dedup: bool = False,
):
    """Set op over each query's CONCATENATED decoded lists.

    blocks/term_block_start/counts: snapshot arena tables.
    idx/found: (Q, K) from resolve_step. k_valid: (Q,).
    SB: static total-block budget per query (callers group queries so that
    every query's blocks fit: sum_k ceil(raw_k/128) <= SB).

    compactor: the final left-compaction of kept lanes — "sort"
    (compaction.compact_rows) or "shift" (compaction.compact_shift: cumsum
    + log2(S) monotone lane shifts, no gathers). Bit-identical outputs.
    "auto" = sort.

    prefix_p > 0 (OR ONLY; callers must not tombstone-filter the result
    afterwards): pagination serving — compact only the first
    prefix_p * K sorted lanes and return (out (Q, <=prefix_p), oc (Q,)
    with oc still the TRUE full count). Exact because for OR every
    distinct valid value is kept and each value occupies <= k_valid <= K
    adjacent lanes after the sort, so the j-th kept value (j <= P) sits
    within the first P*K lanes. This removes the second full-row
    compaction. NOT valid for AND: non-kept runs (< k_valid matches) can
    push the P-th kept value arbitrarily deep.

    wire_dedup (OR ONLY; callers must not tombstone-filter afterwards):
    skip the dedup marking AND the compaction sort entirely — return the
    sorted stream WITH cross-list duplicates and oc = n_valid (valid-lane
    count, pre-dedup). Exact because OR results are sorted UNIQUE, so
    every true wire delta is >= 1 and a ZERO delta uniquely marks a
    duplicate: the host's existing delta unpack drops them in one
    vectorized pass (models/steps._dedup_adjacent) and derives the
    distinct count itself. Removes the second full-row compaction.

    Returns (out (Q, S=SB*128) compacted ascending — or (Q, <=prefix_p)
    under prefix_p, or sorted-with-duplicates under wire_dedup — and
    oc (Q,)).
    """
    if wire_dedup and (prefix_p or op != "or"):
        raise ValueError("wire_dedup is full-result OR only")
    Q, K = idx.shape
    S = SB * BLOCK
    kmask = jnp.arange(K, dtype=jnp.int32)[None, :] < k_valid[:, None]
    live = found & kmask
    cnt = jnp.where(live, counts[idx], 0)            # (Q, K) raw counts
    # named scopes label the stages' kernels in a profiler trace
    with jax.named_scope("concat_decode"):
        rows, in_use, bit, cnt_j, cum = concat_layout(
            term_block_start[idx], cnt, SB)
        flat, vals, mask = decode_masked(blocks, rows, in_use, bit, cnt_j)
    with jax.named_scope("concat_sort"):
        svals = jnp.sort(flat, axis=1)
    return _reduce_runs(svals, vals, mask, cnt, cum, live, kmask, found,
                        k_valid, op, compactor, prefix_p, wire_dedup)


@jax.named_scope("concat_compact")
def _reduce_runs(svals, vals, mask, cnt, cum, live, kmask, found, k_valid,
                 op, compactor, prefix_p, wire_dedup):
    """Run-length reduction + left-compaction of boolean_concat_step's
    sorted rows (see there)."""
    Q, S = svals.shape
    K = cnt.shape[1]
    first = jnp.concatenate(
        [jnp.ones((Q, 1), dtype=bool), svals[:, 1:] != svals[:, :-1]], axis=1
    )
    if op == "and":
        keep = run_reaches_k(svals, k_valid, K) & first & (svals != SENTINEL)
        # genuine 0xFFFFFFFF in every valid list: its run merges with the
        # padding sentinels, so test each list's LAST value instead
        has_ff = (cnt > 0) & (last_values(vals, cum, cnt) == SENTINEL)
        ff_all = jnp.all(has_ff | ~live, axis=1) & (k_valid > 0) & jnp.any(live, axis=1)
        # an absent REQUIRED term voids the AND entirely
        any_missing = jnp.any(kmask & ~found, axis=1)
        keep &= ~any_missing[:, None]
        ff_all &= ~any_missing
        oc = (jnp.sum(keep, axis=1) + ff_all.astype(jnp.int32)).astype(jnp.int32)
    else:  # or
        n_valid = jnp.sum(mask.reshape(Q, S), axis=1).astype(jnp.int32)
        if wire_dedup:
            return svals, n_valid
        in_region = jnp.arange(S, dtype=jnp.int32)[None, :] < n_valid[:, None]
        keep = first & in_region
        oc = jnp.sum(keep, axis=1).astype(jnp.int32)
    from .compaction import compact_rows, compact_shift

    if prefix_p > 0:
        if op != "or":
            raise ValueError("prefix_p windowed compaction is OR-only")
        W = min(S, prefix_p * K)
        out = compact_rows(svals[:, :W], keep[:, :W])[:, : min(W, prefix_p)]
        return out, oc
    if compactor == "auto":
        compactor = "sort"
    if compactor == "shift":
        out, _ = compact_shift(svals, keep)
    else:
        out = compact_rows(svals, keep)
    return out, oc
