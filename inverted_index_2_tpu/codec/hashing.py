"""Open-addressing hash table over packed term keys (exact batched lookup).

Binary search costs ~log2(N) dependent device-memory gathers per query
(each step is a tiny serialized gather). For EXACT lookups (the headline
query path; range/prefix still binary-search) a linear-probe hash table cuts
that to ~2-4 gathers: hash the packed key row with vector ops (no memory
traffic), probe `slots[(h+i) & mask]`, verify the full key row once.

Exactness: the table stores term INDEXES; every probe hit is verified against
the full packed key (word-exact, includes the length tiebreak), so hash
collisions cannot produce false positives. Load factor <= 0.25 (table_size).

The hash is FNV-1a over the key words INCLUDING trailing zero padding —
deliberately, so the same term hashed at different pad widths agrees once
repacked to the snapshot's width (hash inputs are the snapshot-width rows on
both build and query side).
"""
from __future__ import annotations

import numpy as np

FNV_OFFSET = np.uint32(2166136261)
FNV_PRIME = np.uint32(16777619)


def hash_rows_np(keys: np.ndarray) -> np.ndarray:
    """FNV-1a fold + murmur-style avalanche (vectorized numpy).

    The avalanche matters: raw FNV over structured term bytes clusters badly
    under the power-of-two mask, inflating linear-probe chains."""
    with np.errstate(over="ignore"):
        h = np.full(keys.shape[0], FNV_OFFSET, dtype=np.uint32)
        for c in range(keys.shape[1]):
            h = (h ^ keys[:, c]) * FNV_PRIME
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x7FEB352D)
        h ^= h >> np.uint32(15)
        h *= np.uint32(0x846CA68B)
        h ^= h >> np.uint32(16)
    return h


def hash_rows_jnp(keys):
    """Identical math in jax.numpy (device side)."""
    import jax.numpy as jnp

    h = jnp.full(keys.shape[:-1], FNV_OFFSET, dtype=jnp.uint32)
    for c in range(keys.shape[-1]):
        h = (h ^ keys[..., c]) * FNV_PRIME
    h = h ^ (h >> jnp.uint32(16))
    h = h * jnp.uint32(0x7FEB352D)
    h = h ^ (h >> jnp.uint32(15))
    h = h * jnp.uint32(0x846CA68B)
    h = h ^ (h >> jnp.uint32(16))
    return h


def table_size(n: int) -> int:
    """Power-of-two size at load factor <= 0.25 (short probe chains beat the
    memory cost: the table is 16 bytes/term at 4x)."""
    s = 1
    while s < max(4 * n, 8):
        s <<= 1
    return s


def build_table_np(hashes: np.ndarray) -> np.ndarray:
    """Vectorized linear-probe insertion (numpy fallback; native is faster).

    Round-based: every pending key attempts slot (h + offset) & mask; the
    first claimant of each free slot wins, losers retry with offset+1.
    Terminates: each round places >= 1 key (free slots always exist at the
    <= 0.25 load factor enforced by table_size).
    """
    n = len(hashes)
    S = table_size(n)
    mask = np.uint32(S - 1)
    slots = np.full(S, -1, dtype=np.int32)
    pending = np.arange(n, dtype=np.int64)
    offset = np.zeros(n, dtype=np.uint32)
    while len(pending):
        pos = (hashes[pending] + offset[pending]) & mask
        order = np.argsort(pos, kind="stable")
        pos_sorted = pos[order]
        first = np.concatenate([[True], pos_sorted[1:] != pos_sorted[:-1]])
        winners_local = order[first]
        win_pos = pos[winners_local]
        free = slots[win_pos] < 0
        winners = winners_local[free]
        slots[win_pos[free]] = pending[winners].astype(np.int32)
        placed = np.zeros(len(pending), dtype=bool)
        placed[winners] = True
        offset[pending[~placed]] += 1
        pending = pending[~placed]
    return slots


def build_table(keys: np.ndarray) -> np.ndarray:
    """Build the slot table for packed key rows (native C++ when available)."""
    return build_table_with_probes(keys)[0]


def build_table_with_probes(keys: np.ndarray):
    """(slots, max_probes) in one pass — the separate numpy probe-length
    scan cost ~0.1s per million terms at snapshot build."""
    hashes = hash_rows_np(np.ascontiguousarray(keys, dtype=np.uint32))
    from . import native

    if native.available():
        return native.hash_build_with_probes(hashes)
    slots = build_table_np(hashes)
    return slots, max_probe_len(slots, hashes)


def probe_rows_np(slots: np.ndarray, max_probes: int, keys: np.ndarray,
                  qkeys: np.ndarray) -> np.ndarray:
    """Vectorized host-side exact lookup: query key rows -> term indexes
    (int64, -1 = absent). Walks the same probe sequence as the device
    resolve step (ops/dict_search.py) over the same table, with the same
    full-key verification — used by the host serving path
    (QueryEngine.lookup_host), where postings decode natively from the
    retained compact tables and the device is never touched."""
    qkeys = np.ascontiguousarray(qkeys, dtype=np.uint32)
    out = np.full(qkeys.shape[0], -1, dtype=np.int64)
    if len(slots) == 0 or keys.shape[0] == 0 or qkeys.shape[0] == 0:
        return out
    from . import native

    if native.available():  # far faster than this numpy walk
        return native.hash_probe(keys, slots, max_probes, qkeys).astype(
            np.int64
        )
    mask = np.uint32(len(slots) - 1)
    h = hash_rows_np(qkeys)
    open_ = np.arange(qkeys.shape[0], dtype=np.int64)  # still unresolved
    for p in range(max_probes):
        pos = ((h[open_] + np.uint32(p)) & mask).astype(np.int64)
        cand = slots[pos].astype(np.int64)
        occupied = cand >= 0
        # an EMPTY slot terminates the probe chain: a definitive miss
        hit = occupied & (keys[np.maximum(cand, 0)] == qkeys[open_]).all(axis=1)
        out[open_[hit]] = cand[hit]
        open_ = open_[occupied & ~hit]
        if not len(open_):
            break
    return out


def max_probe_len(slots: np.ndarray, hashes: np.ndarray) -> int:
    """Longest probe chain in the table (host check / device trip bound)."""
    S = len(slots)
    mask = np.uint32(S - 1)
    occupied = slots >= 0
    idx = slots[occupied].astype(np.int64)
    pos = np.nonzero(occupied)[0].astype(np.int64)
    home = (hashes[idx] & mask).astype(np.int64)
    dist = (pos - home) % S
    return int(dist.max()) + 1 if len(dist) else 1
