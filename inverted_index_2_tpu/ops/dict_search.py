"""Batched on-device term-dictionary search (the vellum-FST lookup replacement).

The reference resolves ONE term at a time by walking an FST automaton
(/root/reference/file/reader.go:139-150). Here a term dictionary is a sorted
(N, W+1) uint32 key matrix (codec/keys.py layout: big-endian packed bytes +
length tiebreak — exact bytes.Compare order), and lookups are a BATCH:
Q query rows are binary-searched simultaneously with a fixed-trip-count
lax.fori_loop of vectorized lexicographic row compares. Every step is a gather
of (Q, W+1) words plus elementwise compares — no data-dependent control
flow, fully jittable, runs identically on the GPU and the CPU test mesh.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def cmp_rows(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Lexicographic compare of uint32 key rows: -1 / 0 / +1 per row."""
    diff = a != b
    any_diff = jnp.any(diff, axis=-1)
    first = jnp.argmax(diff, axis=-1)
    av = jnp.take_along_axis(a, first[..., None], axis=-1)[..., 0]
    bv = jnp.take_along_axis(b, first[..., None], axis=-1)[..., 0]
    lt = jnp.where(any_diff & (av < bv), -1, 0)
    gt = jnp.where(any_diff & (av > bv), 1, 0)
    return (lt + gt).astype(jnp.int32)


def rows_less(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    diff = a != b
    any_diff = jnp.any(diff, axis=-1)
    first = jnp.argmax(diff, axis=-1)
    av = jnp.take_along_axis(a, first[..., None], axis=-1)[..., 0]
    bv = jnp.take_along_axis(b, first[..., None], axis=-1)[..., 0]
    return any_diff & (av < bv)


def rows_equal(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.all(a == b, axis=-1)


def searchsorted_rows(keys: jnp.ndarray, queries: jnp.ndarray, side: str = "left") -> jnp.ndarray:
    """Vectorized lower/upper bound of query rows within sorted key rows.

    keys: (N, W+1) sorted ascending (lexicographic); queries: (Q, W+1).
    Returns (Q,) int32 insertion points. Fixed trip count ceil(log2(N+1))+1,
    so the jitted program has static shape/control flow.
    """
    n = keys.shape[0]
    q = queries.shape[0]
    if n == 0:
        return jnp.zeros((q,), dtype=jnp.int32)
    steps = max(1, int(math.ceil(math.log2(n + 1))) + 1)

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) >> 1
        rows = keys[jnp.minimum(mid, n - 1)]
        if side == "left":
            go_right = rows_less(rows, queries)
        else:
            go_right = ~rows_less(queries, rows)
        go_right &= mid < hi
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
        return lo, hi

    # derive the initial carry from `keys` so it inherits keys' varying-
    # manual-axes tag under shard_map (each device searches ITS dictionary;
    # a plain zeros() carry would be tagged replicated and fail to unify
    # with the loop body's per-device output)
    z = (keys[0, 0] * 0).astype(jnp.int32)
    lo = jnp.zeros((q,), dtype=jnp.int32) + z
    hi = jnp.full((q,), n, dtype=jnp.int32) + z
    lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
    return lo


def hash_lookup_rows_unrolled(
    keys: jnp.ndarray,
    slots: jnp.ndarray,
    queries: jnp.ndarray,
    max_probes: int,
):
    """Unrolled hash lookup: gather ALL max_probes candidates at once.

    Two wide gathers (slot ids, then candidate key rows) replace the
    while_loop's max_probes dependent iterations — fewer serialized HBM
    round-trips when max_probes is small (Robin Hood keeps it <= ~6).
    Chain-termination semantics preserved: probes past the first empty slot
    are dead (a present key can never live beyond one, by the linear-probe
    invariant)."""
    from ..codec.hashing import hash_rows_jnp

    n = keys.shape[0]
    q = queries.shape[0]
    if n == 0:
        return jnp.zeros((q,), jnp.int32), jnp.zeros((q,), bool)
    S = slots.shape[0]
    mask = jnp.uint32(S - 1)
    h = hash_rows_jnp(queries)
    P = max(1, max_probes)
    pos = (h[:, None] + jnp.arange(P, dtype=jnp.uint32)[None, :]) & mask  # (Q,P)
    cand = slots[pos]                       # (Q,P)
    occupied = cand >= 0
    alive = jnp.cumprod(occupied.astype(jnp.int32), axis=1).astype(bool)
    cand_c = jnp.maximum(cand, 0)
    rows = keys[cand_c]                      # (Q,P,W+1) row gather
    hit = rows_equal(rows, queries[:, None, :]) & alive
    found = jnp.any(hit, axis=1)
    first = jnp.argmax(hit, axis=1)
    idx = jnp.take_along_axis(cand_c, first[:, None], axis=1)[:, 0]
    return idx.astype(jnp.int32), found


def hash_lookup_rows(
    keys: jnp.ndarray,
    slots: jnp.ndarray,
    queries: jnp.ndarray,
    max_probes: int,
):
    """Exact batch lookup via linear-probe hash table: ~2-4 gathers/query vs
    ~log2(N) for binary search (the exact-match path; see
    codec/hashing.py). Returns (idx, found) like lookup_rows.

    slots: (S,) int32 (S a power of two), -1 = empty, else term index.
    max_probes: static bound >= the table's longest probe chain (the host
    builder computes it; load <= 0.5 keeps it tiny).
    """
    from ..codec.hashing import hash_rows_jnp

    n = keys.shape[0]
    q = queries.shape[0]
    if n == 0:
        return jnp.zeros((q,), jnp.int32), jnp.zeros((q,), bool)
    S = slots.shape[0]
    mask = jnp.uint32(S - 1)
    h = hash_rows_jnp(queries)

    def body(state):
        p, idx, found, dead = state
        pos = (h + p) & mask
        cand = slots[pos]
        empty = cand < 0
        cand_c = jnp.maximum(cand, 0)
        hit = rows_equal(keys[cand_c], queries) & ~empty & ~found & ~dead
        idx = jnp.where(hit, cand_c, idx)
        found = found | hit
        dead = dead | empty  # empty slot ends this query's probe chain: miss
        return p + jnp.uint32(1), idx, found, dead

    def cond(state):
        p, idx, found, dead = state
        return (p < max_probes) & jnp.any(~(found | dead))

    # derive initial carries from `slots` so they inherit its varying-
    # manual-axes tag under shard_map (each device probes ITS table)
    z = (slots[0] * 0).astype(jnp.int32)
    state = (
        jnp.uint32(0),
        jnp.zeros((q,), jnp.int32) + z,
        jnp.zeros((q,), bool) | (z != 0),
        jnp.zeros((q,), bool) | (z != 0),
    )
    _, idx, found, _ = jax.lax.while_loop(cond, body, state)
    return idx, found


def lookup_rows(keys: jnp.ndarray, queries: jnp.ndarray):
    """Exact-match batch lookup: returns (idx (Q,) int32, found (Q,) bool).

    idx is the dictionary position of each query term (clamped lower bound);
    found is False for misses (the reference returns no entry for a miss —
    absent map key in PrefixSearch, no FST match).
    """
    n = keys.shape[0]
    idx = searchsorted_rows(keys, queries)
    if n == 0:
        return idx, jnp.zeros(idx.shape, dtype=bool)
    idx_c = jnp.minimum(idx, n - 1)
    found = rows_equal(keys[idx_c], queries) & (idx < n)
    return idx_c, found
