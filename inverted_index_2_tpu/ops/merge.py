"""Device k-way segment merge: compaction as one fixed-shape sort program.

The reference's merge pulls one term at a time through a loser-tree iterator
(/root/reference/shard.go:168-212). Host compaction here (shard.merge_views)
already replaces that with vectorized numpy/C++; THIS module is the on-device
variant for very large compactions: input sizes (N total terms, V total
values) are known, so the whole merge is static-shape:

    1. multi-key stable sort of packed term keys (jax.lax.sort, the exact
       bytes.Compare order of codec/keys.py)
    2. adjacent-equal grouping -> group ids
    3. (group, value) two-key sort -> per-group sorted values
    4. first-occurrence dedupe + tombstone searchsorted mask
    5. stable compaction of survivors (kept-first three-key sort) +
       per-group survivor counts via scatter-add

The host wrapper merge_views_device() mirrors shard.merge_views' contract
(blob, offsets, values, value_offsets | None) bit-for-bit — asserted by
tests/test_device_merge.py — so Shard.merge can swap it in for big merges.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp


def _sort_key_rows(keys: jnp.ndarray):
    """Stable lexicographic sort of (N, Wp1) rows; returns permutation."""
    N, Wp1 = keys.shape
    idx = jnp.arange(N, dtype=jnp.int32)
    ops = tuple(keys[:, c] for c in range(Wp1)) + (idx,)
    out = jax.lax.sort(ops, dimension=0, num_keys=Wp1, is_stable=True)
    return out[-1], jnp.stack(out[:-1], axis=1)


def merge_device_step(keys_all, term_of_value, values, removed):
    """Jittable core. Shapes: keys_all (N, Wp1); term_of_value (V,) int32
    (index into keys_all rows); values (V,) uint32; removed (R,) uint32
    sorted (R may be 0).

    Returns:
      perm (N,) int32              original row of each sorted position
      group_head (N,) bool         sorted position starts a new term group
      group_of_pos (N,) int32      group id per sorted position
      kept_count () int32          total surviving values
      out_values (V,) uint32       survivors first, (group,value) ordered
      out_group (V,) int32         survivor group ids (aligned, garbage after
                                   kept_count)
      group_counts (N,) int32      survivors per group id
    """
    N = keys_all.shape[0]
    perm, sorted_keys = _sort_key_rows(keys_all)
    neq = jnp.any(sorted_keys[1:] != sorted_keys[:-1], axis=1)
    group_head = jnp.concatenate([jnp.ones((1,), bool), neq])
    group_of_pos = jnp.cumsum(group_head.astype(jnp.int32)) - 1
    # term row -> group id (scatter through the permutation)
    group_of_term = jnp.zeros((N,), jnp.int32).at[perm].set(group_of_pos)

    g = group_of_term[term_of_value]
    # two-key sort: (group, value)
    gs, vs = jax.lax.sort((g, values), dimension=0, num_keys=2, is_stable=True)
    dup = jnp.concatenate(
        [jnp.zeros((1,), bool), (gs[1:] == gs[:-1]) & (vs[1:] == vs[:-1])]
    )
    keep = ~dup
    R = removed.shape[0]
    if R > 0:
        pos = jnp.searchsorted(removed, vs)
        hit = removed[jnp.minimum(pos, R - 1)] == vs
        hit &= pos < R
        keep &= ~hit
    # compact survivors to the front, preserving (group, value) order
    rank = jnp.where(keep, jnp.int32(0), jnp.int32(1))
    _, out_group, out_values = jax.lax.sort(
        (rank, gs, vs), dimension=0, num_keys=3, is_stable=True
    )
    kept_count = jnp.sum(keep).astype(jnp.int32)
    group_counts = jnp.zeros((N,), jnp.int32).at[gs].add(keep.astype(jnp.int32))
    return perm, group_head, group_of_pos, kept_count, out_values, out_group, group_counts


_JIT_MERGE = jax.jit(merge_device_step)


def merge_views_device(views: List, removed: Optional[np.ndarray] = None):
    """Device-compaction twin of shard.merge_views (same contract)."""
    from ..codec import keys as keys_mod
    from ..utils.ragged import ragged_gather

    views = [v for v in views if v.n_terms > 0]
    if not views:
        return None
    W = max(keys_mod.width_words(v.max_term_len) for v in views)
    keys_all = np.concatenate([v.keys(W) for v in views], axis=0)
    N = keys_all.shape[0]

    vals_parts, tov_parts = [], []
    base = 0
    for v in views:
        vals, counts, voffs = v.decode_all()
        vals_parts.append(vals)
        tov_parts.append(
            np.repeat(np.arange(v.n_terms, dtype=np.int32) + base, counts)
        )
        base += v.n_terms
    all_vals = np.concatenate(vals_parts)
    term_of_value = np.concatenate(tov_parts)
    if len(all_vals) == 0:
        return None
    rem = (
        np.asarray(removed, dtype=np.uint32)
        if removed is not None
        else np.zeros(0, np.uint32)
    )

    # ---- shape bucketing: real merges never repeat exact (N, V, R, W)
    # shapes, and an unbucketed call would recompile (seconds each) every
    # time. Pad every dimension to the next power of two:
    #  * terms: extra all-0xFFFFFFFF key rows (impossible length word) sort
    #    LAST and form one pad group
    #  * values: 0xFFFFFFFF values tagged to the first pad row; they compact
    #    to the END of the kept region (the pad group has the largest id)
    #    and are excluded below by rep_orig < N_real
    #  * removed: repeat the last element (sorted order and membership
    #    semantics unchanged)
    def _pow2(x: int) -> int:
        return 1 << max(0, x - 1).bit_length()

    N_real = N
    Wp1 = keys_all.shape[1]
    W2p1 = _pow2(Wp1 - 1) + 1
    N_pad = _pow2(N_real + 1)  # always >= N_real+1: pad values need a pad row
    keys_pad = np.full((N_pad, W2p1), 0xFFFFFFFF, dtype=np.uint32)
    keys_pad[:N_real, : Wp1 - 1] = keys_all[:, :-1]
    keys_pad[:N_real, Wp1 - 1 : W2p1 - 1] = 0
    keys_pad[:N_real, -1] = keys_all[:, -1]
    V_real = len(all_vals)
    V_pad = _pow2(V_real)
    vals_p = np.full(V_pad, 0xFFFFFFFF, dtype=np.uint32)
    vals_p[:V_real] = all_vals
    tov_p = np.full(V_pad, N_real, dtype=np.int32)
    tov_p[:V_real] = term_of_value
    if len(rem):
        rem_p = np.full(_pow2(len(rem)), rem[-1], dtype=np.uint32)
        rem_p[: len(rem)] = rem
    else:
        rem_p = rem
    keys_all, all_vals, term_of_value, rem = keys_pad, vals_p, tov_p, rem_p

    perm, group_head, group_of_pos, kept, out_values, out_group, group_counts = (
        _JIT_MERGE(
            jnp.asarray(keys_all),
            jnp.asarray(term_of_value),
            jnp.asarray(all_vals),
            jnp.asarray(rem),
        )
    )
    kept = int(kept)
    if kept == 0:
        return None
    out_values = np.asarray(out_values)[:kept]
    out_group = np.asarray(out_group)[:kept]
    group_counts = np.asarray(group_counts)
    perm = np.asarray(perm)
    group_head = np.asarray(group_head)

    # groups with surviving values, ascending (== term order); drop the pad
    # group (its representative row is a pad row, rep_orig >= N_real — pads
    # sort last, so real groups own the PREFIX of the kept value region)
    kept_groups = np.unique(out_group)
    head_pos = np.nonzero(group_head)[0]
    rep_orig = perm[head_pos[kept_groups]]
    real = rep_orig < N_real
    kept_groups = kept_groups[real]
    rep_orig = rep_orig[real]
    if len(kept_groups) == 0:
        return None
    voffs = np.zeros(len(kept_groups) + 1, dtype=np.int64)
    np.cumsum(group_counts[kept_groups], out=voffs[1:])
    n_per = np.array([v.n_terms for v in views], dtype=np.int64)
    view_base = np.zeros(len(views) + 1, dtype=np.int64)
    np.cumsum(n_per, out=view_base[1:])
    view_idx = np.searchsorted(view_base, rep_orig, side="right") - 1
    blob_parts = [v.blob for v in views]
    blob_base = np.zeros(len(views) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blob_parts], out=blob_base[1:])
    all_blob = np.concatenate(blob_parts)
    term_starts = np.concatenate([v.offsets[:-1] for v in views])
    term_lens = np.concatenate([np.diff(v.offsets) for v in views])
    g_tstart = term_starts[rep_orig] + blob_base[view_idx]
    g_tlen = term_lens[rep_orig]
    out_blob, _ = ragged_gather(all_blob, g_tstart, g_tlen)
    out_offsets = np.zeros(len(kept_groups) + 1, dtype=np.int64)
    np.cumsum(g_tlen, out=out_offsets[1:])

    # real groups own the prefix of the kept region; drop pad survivors
    return out_blob.tobytes(), out_offsets, out_values[: int(voffs[-1])], voffs
