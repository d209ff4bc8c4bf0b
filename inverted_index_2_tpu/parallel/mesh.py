"""Multi-chip sharding: the index's shard axis mapped onto a device Mesh.

The reference parallelizes across up to 1024 prefix shards with goroutines in
one process (/root/reference/inverted_index.go:46-103). Here the same shard
axis becomes a `jax.sharding.Mesh` axis: the 10-bit shard-key space is split
into contiguous ranges, one per device; each device holds the frozen snapshot
of its shard range (dictionary + postings), padded to a common shape and
stacked. Queries are replicated to all devices (fan-out); each device answers
for terms it owns; results merge with a `psum` collective — exactness holds
because a term's postings live on EXACTLY ONE device (disjoint key ranges),
so the sum has a single non-zero contributor per query.

This is the DP-like axis of this workload (SURVEY §2.2): there is no tensor
to split per-op; scaling = partitioning index state + fan-out/merge
collectives.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models import query_engine as qe
from ..shard import merge_views

SHARD_AXIS = "shards"

# padding key row: sorts after every real term (length word 0xFFFFFFFF is
# impossible for a real term) and can never equal a real query key.
_PAD_WORD = 0xFFFFFFFF


@dataclass
class ShardedSnapshot:
    """Per-device snapshot partitions, padded to equal shapes and stacked.

    Leading axis = device along the `shards` mesh axis.
    """

    keys: jnp.ndarray               # (D, Nmax, W+1)
    blocks: jnp.ndarray             # (D, Bmax, stride) block row arenas
    term_block_start: jnp.ndarray   # (D, Nmax+1)
    counts: jnp.ndarray             # (D, Nmax)
    hash_slots: jnp.ndarray         # (D, S) common power-of-two table size
    mesh: Mesh
    width: int
    max_probes: int = 1
    max_count: int = 0              # longest posting list across partitions
                                    # (sizes the exact re-serve ladder)
    # compiled shard_map programs, keyed by (kind, params): rebuilding the
    # jit closure per call would recompile every time
    _jit_cache: Dict[Tuple, Callable] = field(
        default_factory=dict, repr=False, compare=False
    )

    @property
    def n_devices(self) -> int:
        return self.keys.shape[0]


def _pad_partition(snap: qe.IndexSnapshot, Nmax: int, Bmax: int, stride: int, W: int):
    """Pad one device partition to the common shape (host numpy)."""
    n = snap.n_terms
    keys = np.full((Nmax, W + 1), _PAD_WORD, dtype=np.uint32)
    if n:
        k = np.asarray(snap.keys)
        keys[:n, : k.shape[1]] = k
        if k.shape[1] < W + 1:  # widen: move length word to last column
            keys[:n, W] = k[:, -1]
            keys[:n, k.shape[1] - 1 : W] = 0
    blocks = np.zeros((Bmax, stride), dtype=np.uint32)
    bl = np.asarray(snap.blocks)
    blocks[: bl.shape[0], : bl.shape[1]] = bl
    tbs = np.zeros(Nmax + 1, dtype=np.int32)
    t = np.asarray(snap.term_block_start)
    tbs[: len(t)] = t
    tbs[len(t) :] = t[-1] if len(t) else 0
    counts = np.zeros(Nmax, dtype=np.int32)
    c = np.asarray(snap.counts)
    counts[: len(c)] = c
    return keys, blocks, tbs, counts


def shard_ranges(n_devices: int, fanout: int = 1024) -> List[range]:
    """Contiguous split of the shard-key space ("0000".."1023") per device."""
    per = -(-fanout // n_devices)
    return [range(d * per, min((d + 1) * per, fanout)) for d in range(n_devices)]


def _shard_block_rows(sh) -> int:
    """Upper-bound arena BLOCK rows a shard contributes: Σ ceil(len/128)
    per term per segment (union across segments can only shrink it).
    Direct segments hold one value per term = one block row each."""
    total = 0
    for seg in sh.segments.snapshot():
        v = seg.view
        if v is None:
            continue
        if v.mode == 1:  # MODE_DIRECT
            total += v.n_terms
        elif v.n_terms:
            cnts = v.words[v.outs.astype(np.int64)].astype(np.int64)
            total += int(np.sum((cnts + 127) // 128))
    return total


def balanced_ranges(
    index, n_devices: int, fanout: int = 1024, by: str = "blocks"
) -> List[range]:
    """Contiguous shard-key ranges cut at ~equal BLOCK volume (by="terms"
    cuts on term counts instead).

    Contiguity preserves the global-order invariant (device order = term
    order); cutting by data volume instead of key count fixes the skew of
    real corpora, whose term prefixes concentrate in a narrow band of the
    10-bit space (e.g. lowercase ASCII spans only ~100 of 1024 keys).
    BLOCK volume is the right cut metric because partitions pad to the
    largest device's (Bmax, stride) arena: one device with long posting
    lists inflates EVERY device's HBM, even at equal term counts."""
    per_key = np.zeros(fanout, dtype=np.int64)
    for sh in index._snapshot():
        try:
            k = int(sh.get_key())
        except ValueError:
            continue
        if by == "blocks":
            per_key[k] = _shard_block_rows(sh)
        else:
            per_key[k] = sum(s.terms for s in sh.segments.snapshot())
    total = int(per_key.sum())
    if total == 0:
        return shard_ranges(n_devices, fanout)
    cum = np.cumsum(per_key)
    bounds = [0]
    for d in range(1, n_devices):
        cut = int(np.searchsorted(cum, total * d // n_devices, side="left")) + 1
        bounds.append(min(max(cut, bounds[-1]), fanout))
    bounds.append(fanout)
    return [range(bounds[d], bounds[d + 1]) for d in range(n_devices)]


def build_sharded_snapshot(
    index, mesh: Mesh, width: Optional[int] = None
) -> ShardedSnapshot:
    """Freeze an InvertedIndex into per-device partitions along `mesh`'s
    shard axis. Shard dirs are routed to devices by contiguous shard-key
    ranges cut at ~equal block volume (global term order = device order for
    terms >= 2 bytes; see balanced_ranges for the skew rationale). The
    partitions are built as HOST tables and stacked before any device
    touch: only compressed words cross the wire, and the padded arenas
    expand with one sharded device gather (stack_tables)."""
    n_dev = mesh.shape[SHARD_AXIS]
    ranges = balanced_ranges(index, n_dev)
    parts: List[qe.HostTables] = []
    for r in ranges:
        views = []
        for sh in index._snapshot():
            try:
                k = int(sh.get_key())
            except ValueError:
                continue
            if k in r:
                views.extend(
                    s.view for s in sh.segments.snapshot() if s.view is not None
                )
        merged = merge_views(views, None)
        if merged is None:
            parts.append(qe._empty_tables(width or 1))
        else:
            blob, offsets, values, voffs = merged
            parts.append(
                qe.build_host_tables(blob, offsets, values, voffs, None, width, build_hash=False)
            )
    return stack_tables(parts, mesh)


def partition_tables(t: "qe.HostTables", n_dev: int) -> List["qe.HostTables"]:
    """Cut ONE global HostTables (e.g. a loaded checkpoint,
    models/checkpoint.py) into `n_dev` contiguous TERM ranges balanced by
    BLOCK volume — the same skew rationale as balanced_ranges, but cutting
    in term space directly (no index needed): contiguity preserves global
    term order across devices, and any disjoint contiguous cut keeps the
    single-owner-per-term exactness of the psum merge.

    Partition hash tables are NOT built here (slots stay empty):
    stack_tables builds per-device tables at one common size over the
    WIDENED key rows."""
    N = t.n_terms
    if N == 0:
        return [qe._empty_tables(t.width) for _ in range(n_dev)]
    tbs64 = t.tbs.astype(np.int64)
    cum = tbs64[1:]  # cumulative block rows after each term
    total = int(cum[-1])
    bounds = [0]
    for d in range(1, n_dev):
        cut = int(np.searchsorted(cum, total * d // n_dev, side="left")) + 1
        bounds.append(min(max(cut, bounds[-1]), N))
    bounds.append(N)
    parts: List[qe.HostTables] = []
    for d in range(n_dev):
        t0, t1 = bounds[d], bounds[d + 1]
        if t1 <= t0:
            parts.append(qe._empty_tables(t.width))
            continue
        parts.append(_slice_tables(t, t0, t1))
    return parts


def _slice_tables(t: "qe.HostTables", t0: int, t1: int) -> "qe.HostTables":
    """Term-range [t0, t1) slice of HostTables (host-only, no hash)."""
    N = t.n_terms
    tbs64 = t.tbs.astype(np.int64)
    b0, b1 = int(tbs64[t0]), int(tbs64[t1])
    w0 = int(t.flat[b0]) - 1  # count word precedes the first block
    w1 = int(t.flat[b1]) - 1 if t1 < N else len(t.words)
    counts = t.counts[t0:t1]
    return qe.HostTables(
        keys=t.keys[t0:t1],
        words=t.words[w0:w1],
        flat=(t.flat[b0:b1] - w0).astype(np.int32),
        tbs=(t.tbs[t0 : t1 + 1] - t.tbs[t0]).astype(np.int32),
        counts=counts,
        removed=np.zeros(0, np.uint32),  # tombstones replicate engine-side
        slots=np.full(8, -1, dtype=np.int32),
        max_probes=1,
        max_count=int(counts.max()) if len(counts) else 0,
        width=t.width,
        # global max_bw: every partition shares one stride anyway (the
        # stacked arena is (D, Bmax, stride)); per-part recompute would
        # just be re-derived as the max at stack time
        max_bw=t.max_bw,
    )


def _pad_table_keys(keys: np.ndarray, Nmax: int, W: int) -> np.ndarray:
    """Pad a (n, w+1) key matrix to (Nmax, W+1) with _PAD_WORD rows,
    widening real rows by zero-filling before the length word."""
    n, w1 = keys.shape
    out = np.full((Nmax, W + 1), _PAD_WORD, dtype=np.uint32)
    if n:
        out[:n, : w1 - 1] = keys[:, :-1]
        out[:n, w1 - 1 : W] = 0
        out[:n, W] = keys[:, -1]
    return out


def stack_tables(parts: List["qe.HostTables"], mesh: Mesh) -> ShardedSnapshot:
    """Pad host-table partitions to a common shape, build per-device hash
    tables at one power-of-two size, ship ONLY the compressed words, and
    expand every device's block arena with one sharded gather on device —
    the warm half of build_sharded_snapshot / the mesh checkpoint load.

    The arena stride stays compact, as in the single-device snapshot."""
    from ..codec import hashing, native

    W = max(p.width for p in parts)
    Nmax = max(max(p.n_terms for p in parts), 1)
    Bmax = max(max(len(p.flat) for p in parts), 1)
    Tmax = max(max(len(p.words) for p in parts), 1)
    stride = max(4, max(p.max_bw for p in parts) + 1)
    S = hashing.table_size(Nmax)

    keys_pad, tbs_pad, counts_pad, flat_pad, words_pad = [], [], [], [], []
    tables, probes = [], 1
    for p in parts:
        n = p.n_terms
        kp = _pad_table_keys(p.keys, Nmax, W)
        keys_pad.append(kp)
        tbs = np.zeros(Nmax + 1, dtype=np.int32)
        tbs[: len(p.tbs)] = p.tbs
        tbs[len(p.tbs) :] = p.tbs[-1] if len(p.tbs) else 0
        tbs_pad.append(tbs)
        c = np.zeros(Nmax, dtype=np.int32)
        c[:n] = p.counts
        counts_pad.append(c)
        # pad rows point one past the real words: the zero tail decodes as
        # an empty block and is unreachable anyway (tbs caps real rows)
        fl = np.full(Bmax, len(p.words), dtype=np.int32)
        fl[: len(p.flat)] = p.flat
        flat_pad.append(fl)
        wp = np.zeros(Tmax + stride, dtype=np.uint32)
        wp[: len(p.words)] = p.words
        words_pad.append(wp)
        slots = np.full(S, -1, dtype=np.int32)
        if n:
            h = hashing.hash_rows_np(kp[:n])
            if native.available():
                slots, mp = native.hash_build_with_probes(h, S=S)
                probes = max(probes, mp)
            else:
                mask = np.uint32(S - 1)
                for i, hv in enumerate(h):
                    pos = np.uint32(hv) & mask
                    while slots[pos] >= 0:
                        pos = (pos + np.uint32(1)) & mask
                    slots[pos] = i
                probes = max(probes, hashing.max_probe_len(slots, h))
        tables.append(slots)

    shard = NamedSharding(mesh, P(SHARD_AXIS))
    wp_dev = jax.device_put(np.stack(words_pad, axis=0), shard)
    fl_dev = jax.device_put(np.stack(flat_pad, axis=0), shard)
    col = jnp.arange(stride, dtype=jnp.int32)
    expand = jax.jit(
        jax.vmap(lambda w, f: w[f[:, None] + col[None, :]]),
        out_shardings=shard,
    )
    blocks = expand(wp_dev, fl_dev)
    return ShardedSnapshot(
        keys=jax.device_put(np.stack(keys_pad, axis=0), shard),
        blocks=blocks,
        term_block_start=jax.device_put(np.stack(tbs_pad, axis=0), shard),
        counts=jax.device_put(np.stack(counts_pad, axis=0), shard),
        hash_slots=jax.device_put(np.stack(tables, axis=0), shard),
        mesh=mesh,
        width=W,
        max_probes=probes,
        max_count=max(p.max_count for p in parts),
    )


def stack_partitions(parts: List[qe.IndexSnapshot], mesh: Mesh) -> ShardedSnapshot:
    from ..codec import hashing

    W = max(p.width for p in parts)
    Nmax = max(max(p.n_terms for p in parts), 1)
    Bmax = max(max(int(p.blocks.shape[0]) for p in parts), 1)
    stride = max(int(p.blocks.shape[1]) for p in parts)
    padded = [_pad_partition(p, Nmax, Bmax, stride, W) for p in parts]
    # per-device hash tables at ONE power-of-two size (the probe math uses
    # S-1 as the mask, so every device must share S)
    S = hashing.table_size(Nmax)
    tables, probes = [], 1
    for pp in padded:
        keys_np, _, _, counts_np = pp
        n = int((keys_np[:, -1] != 0xFFFFFFFF).sum())  # real rows (pad has len word max)
        h = hashing.hash_rows_np(keys_np[:n])
        slots = np.full(S, -1, dtype=np.int32)
        mask = np.uint32(S - 1)
        if n:
            from ..codec import native

            if native.available():
                slots, mp = native.hash_build_with_probes(h, S=S)
                probes = max(probes, mp)
            else:
                full = hashing.build_table_np(h)
                # rebuild at size S if the fallback chose a different size
                if len(full) != S:
                    slots = np.full(S, -1, dtype=np.int32)
                    for i, hv in enumerate(h):
                        pos = np.uint32(hv) & mask
                        while slots[pos] >= 0:
                            pos = (pos + np.uint32(1)) & mask
                        slots[pos] = i
                else:
                    slots = full
                probes = max(probes, hashing.max_probe_len(slots, h))
        tables.append(slots)
    stack = lambda i: np.stack([pp[i] for pp in padded], axis=0)
    shard = NamedSharding(mesh, P(SHARD_AXIS))
    return ShardedSnapshot(
        keys=jax.device_put(stack(0), shard),
        blocks=jax.device_put(stack(1), shard),
        term_block_start=jax.device_put(stack(2), shard),
        counts=jax.device_put(stack(3), shard),
        hash_slots=jax.device_put(np.stack(tables, axis=0), shard),
        mesh=mesh,
        width=W,
        max_probes=probes,
        max_count=max(p.max_count for p in parts),
    )


# ---------------------------------------------------------------------------
# SPMD query steps (shard_map over the mesh)
# ---------------------------------------------------------------------------


def _local_lookup(keys, blocks, tbs, counts, slots, qkeys, L, max_probes):
    """Per-device block: answer for owned terms, zero elsewhere.

    Returns (found, vals, n, raw): n is the served count (clamped to L),
    raw the term's TRUE posting count — raw > L signals the row was clipped
    and the caller must re-serve that query at a larger ladder L (same
    exactness protocol as the single-chip QueryEngine)."""
    found, vals, n, raw = qe.lookup_step(
        keys[0], blocks[0], tbs[0], counts[0], qkeys, L,
        slots[0], max_probes,
    )
    vals = jnp.where((found & (n > 0))[:, None], vals, jnp.uint32(0))
    n = jnp.where(found, n, 0)
    return found, vals, n, raw


def make_sharded_lookup(snap: ShardedSnapshot, L: int):
    """Compile the fan-out lookup: queries replicated in, results psum'd
    across devices (single owner per term => sum == owner's answer).

    Returns (found, vals, n, raw) per query; raw > L flags truncation (the
    owning device's true count survives the psum since misses contribute 0).
    """
    _ck = ("lookup", L)
    if _ck in snap._jit_cache:
        return snap._jit_cache[_ck]
    probes = snap.max_probes

    def step(keys, blocks, tbs, counts, slots, qkeys):
        found, vals, n, raw = _local_lookup(keys, blocks, tbs, counts, slots, qkeys, L, probes)
        found = jax.lax.psum(found.astype(jnp.int32), SHARD_AXIS) > 0
        vals = jax.lax.psum(vals, SHARD_AXIS)
        n = jax.lax.psum(n, SHARD_AXIS)
        raw = jax.lax.psum(raw, SHARD_AXIS)
        return found, vals, n, raw

    mapped = shard_map(
        step,
        mesh=snap.mesh,
        in_specs=(P(SHARD_AXIS),) * 5 + (P(),),
        out_specs=(P(), P(), P(), P()),
    )
    jitted = jax.jit(mapped)

    def call(keys, blocks, tbs, counts, qkeys):
        return jitted(keys, blocks, tbs, counts, snap.hash_slots, qkeys)

    snap._jit_cache[_ck] = call
    return call


def make_sharded_lookup_scatter(snap: ShardedSnapshot, L: int):
    """make_sharded_lookup with the result merge as a REDUCE-SCATTER: the
    psum is an all-reduce (reduce-scatter + all-gather); since
    every caller consumes the results on the host anyway, the broadcast
    leg is pure waste — psum_scatter returns each device its Q/D tile at
    half the wire cost, and the host fetch of the query-sharded outputs
    moves the same bytes it always did. Identical (found, vals, n, raw)
    contract; Q pads to a device multiple internally."""
    _ck = ("lookup_rs", L)
    if _ck in snap._jit_cache:
        return snap._jit_cache[_ck]
    probes = snap.max_probes
    D = snap.n_devices

    def _rs(x):
        return jax.lax.psum_scatter(
            x, SHARD_AXIS, scatter_dimension=0, tiled=True
        )

    def step(keys, blocks, tbs, counts, slots, qkeys):
        found, vals, n, raw = _local_lookup(keys, blocks, tbs, counts, slots, qkeys, L, probes)
        found = _rs(found.astype(jnp.int32)) > 0
        vals = _rs(vals)
        n = _rs(n)
        raw = _rs(raw)
        return found, vals, n, raw

    mapped = shard_map(
        step,
        mesh=snap.mesh,
        in_specs=(P(SHARD_AXIS),) * 5 + (P(),),
        out_specs=(P(SHARD_AXIS),) * 4,
    )
    jitted = jax.jit(mapped)

    def call(keys, blocks, tbs, counts, qkeys):
        Q = qkeys.shape[0]
        Qp = -(-Q // D) * D
        if Qp != Q:
            qkeys = jnp.concatenate(
                [qkeys, jnp.zeros((Qp - Q, *qkeys.shape[1:]), qkeys.dtype)]
            )
        out = jitted(keys, blocks, tbs, counts, snap.hash_slots, qkeys)
        if Qp != Q:
            out = tuple(a[:Q] for a in out)
        return out

    snap._jit_cache[_ck] = call
    return call


def make_sharded_boolean(snap: ShardedSnapshot, L: int, op: str):
    """Fan-out boolean queries: per-term postings fetched on the owning
    device, merged by psum, then the set op runs replicated (its inputs are
    already global).

    Returns (out, oc, need): need is the largest TRUE posting count among
    each query's present terms — need > L means the result may be incomplete
    and the caller must re-serve that query through a program compiled at a
    larger ladder L (make_sharded_boolean(snap, L2, op)); mirrors the
    single-chip boolean_step contract."""
    _ck = ("bool", L, op)
    if _ck in snap._jit_cache:
        return snap._jit_cache[_ck]
    from ..ops import setops

    probes = snap.max_probes

    def step(keys, blocks, tbs, counts, slots, qkeys, k_valid):
        Q, K, Wp1 = qkeys.shape
        flat = qkeys.reshape(Q * K, Wp1)
        found, vals, n, raw = _local_lookup(keys, blocks, tbs, counts, slots, flat, L, probes)
        vals = jax.lax.psum(vals, SHARD_AXIS)
        n = jax.lax.psum(n, SHARD_AXIS)
        raw = jax.lax.psum(raw, SHARD_AXIS)
        lists = vals.reshape(Q, K, L)
        ncnt = n.reshape(Q, K)
        kmask = jnp.arange(K, dtype=jnp.int32)[None, :] < k_valid[:, None]
        need = jnp.max(
            jnp.where(kmask, raw.reshape(Q, K), 0), axis=1
        ).astype(jnp.int32)
        if op == "and":
            out, oc = setops.intersect_many(lists, ncnt, k_valid)
        else:
            out, oc = setops.union_many(lists, ncnt, k_valid)
        return out, oc, need

    mapped = shard_map(
        step,
        mesh=snap.mesh,
        in_specs=(P(SHARD_AXIS),) * 5 + (P(), P()),
        out_specs=(P(), P(), P()),
    )
    jitted = jax.jit(mapped)

    def call(keys, blocks, tbs, counts, qkeys, k_valid):
        return jitted(keys, blocks, tbs, counts, snap.hash_slots, qkeys, k_valid)

    snap._jit_cache[_ck] = call
    return call


def make_sharded_boolean_scatter(snap: ShardedSnapshot, L: int, op: str):
    """Fan-out boolean with REDUCE-SCATTER query partitioning.

    make_sharded_boolean psum-replicates the (Q, K, L) decode, so every
    device then runs the FULL sort/intersect stage redundantly — the
    dominant config-3 cost doesn't scale with the mesh. Here the same
    owner-device decode is followed by a psum_scatter over the query axis:
    device d receives the complete rows of its Q/D query tile (the psum and
    the scatter are one fused reduce-scatter, same reduce volume,
    1/D the output), and the set op runs once per query across the mesh.
    Results return query-sharded; the caller-visible (out, oc, need)
    contract matches make_sharded_boolean bit-for-bit.

    The returned call pads Q to a device multiple internally."""
    _ck = ("bool_rs", L, op)
    if _ck in snap._jit_cache:
        return snap._jit_cache[_ck]
    from ..ops import setops

    probes = snap.max_probes
    D = snap.n_devices

    def step(keys, blocks, tbs, counts, slots, qkeys, k_valid):
        Q, K, Wp1 = qkeys.shape
        Qd = Q // D
        flat = qkeys.reshape(Q * K, Wp1)
        found, vals, n, raw = _local_lookup(
            keys, blocks, tbs, counts, slots, flat, L, probes
        )
        vals = jax.lax.psum_scatter(
            vals.reshape(Q, K * L), SHARD_AXIS, scatter_dimension=0, tiled=True
        ).reshape(Qd, K, L)
        n = jax.lax.psum_scatter(
            n.reshape(Q, K), SHARD_AXIS, scatter_dimension=0, tiled=True
        )
        raw = jax.lax.psum_scatter(
            raw.reshape(Q, K), SHARD_AXIS, scatter_dimension=0, tiled=True
        )
        i0 = jax.lax.axis_index(SHARD_AXIS) * Qd
        kv = jax.lax.dynamic_slice_in_dim(k_valid, i0, Qd)
        kmask = jnp.arange(K, dtype=jnp.int32)[None, :] < kv[:, None]
        need = jnp.max(jnp.where(kmask, raw, 0), axis=1).astype(jnp.int32)
        if op == "and":
            out, oc = setops.intersect_many(vals, n, kv)
        else:
            out, oc = setops.union_many(vals, n, kv)
        return out, oc, need

    mapped = shard_map(
        step,
        mesh=snap.mesh,
        in_specs=(P(SHARD_AXIS),) * 5 + (P(), P()),
        out_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS)),
    )
    jitted = jax.jit(mapped)

    def call(keys, blocks, tbs, counts, qkeys, k_valid):
        Q = qkeys.shape[0]
        Qp = -(-Q // D) * D
        if Qp != Q:
            qkeys = jnp.concatenate(
                [qkeys, jnp.zeros((Qp - Q, *qkeys.shape[1:]), qkeys.dtype)]
            )
            k_valid = jnp.concatenate(
                [k_valid, jnp.zeros(Qp - Q, dtype=k_valid.dtype)]
            )
        out, oc, need = jitted(keys, blocks, tbs, counts, snap.hash_slots, qkeys, k_valid)
        if Qp != Q:
            out, oc, need = out[:Q], oc[:Q], need[:Q]
        return out, oc, need

    snap._jit_cache[_ck] = call
    return call


# compiled dual-tier programs, keyed independently of the delta snapshot
# object (deltas churn on every refresh; the program depends only on mesh,
# shapes and statics — jax.jit then retraces per array shape as usual)
_DUAL_JIT_CACHE: Dict[Tuple, Callable] = {}


def make_sharded_boolean_dual(
    snap: ShardedSnapshot, dsnap: ShardedSnapshot, L: int, op: str
):
    """Fan-out boolean over a MAIN + DELTA sharded snapshot pair: each tier
    resolves and psums its per-term postings independently (a term may live
    on DIFFERENT devices in the two tiers — each psum has a single owner),
    the pair unions per (query, slot), then the set op runs replicated —
    the mesh twin of models.query_engine.boolean_step_dual.

    Returns call(qk1, qk2, k_valid) -> (out (Q, 2L), oc, need) where qk1/qk2
    are the SAME queries packed at each tier's width."""
    from ..ops import setops

    key = (snap.mesh, L, op, snap.max_probes, dsnap.max_probes)
    probes1, probes2 = snap.max_probes, dsnap.max_probes
    jitted = _DUAL_JIT_CACHE.get(key)
    if jitted is None:
        def step(k1, b1, t1, c1, s1, k2, b2, t2, c2, s2, qk1, qk2, k_valid):
            Q, K, W1 = qk1.shape
            f1, v1, n1, r1 = _local_lookup(
                k1, b1, t1, c1, s1, qk1.reshape(Q * K, W1), L, probes1)
            v1 = jax.lax.psum(v1, SHARD_AXIS)
            n1 = jax.lax.psum(n1, SHARD_AXIS)
            r1 = jax.lax.psum(r1, SHARD_AXIS)
            f2, v2, n2, r2 = _local_lookup(
                k2, b2, t2, c2, s2, qk2.reshape(Q * K, qk2.shape[-1]), L,
                probes2)
            v2 = jax.lax.psum(v2, SHARD_AXIS)
            n2 = jax.lax.psum(n2, SHARD_AXIS)
            r2 = jax.lax.psum(r2, SHARD_AXIS)
            pair = jnp.stack([v1, v2], axis=1)                  # (QK, 2, L)
            pcnt = jnp.stack([n1, n2], axis=1)
            u, uc = setops.union_many(
                pair, pcnt, jnp.full((Q * K,), 2, jnp.int32))
            lists = u.reshape(Q, K, 2 * L)
            ncnt = uc.reshape(Q, K)
            kmask = jnp.arange(K, dtype=jnp.int32)[None, :] < k_valid[:, None]
            need = jnp.max(
                jnp.where(kmask, (r1 + r2).reshape(Q, K), 0), axis=1
            ).astype(jnp.int32)
            if op == "and":
                out, oc = setops.intersect_many(lists, ncnt, k_valid)
            else:
                out, oc = setops.union_many(lists, ncnt, k_valid)
            return out, oc, need

        mapped = shard_map(
            step,
            mesh=snap.mesh,
            in_specs=(P(SHARD_AXIS),) * 10 + (P(), P(), P()),
            out_specs=(P(), P(), P()),
        )
        jitted = jax.jit(mapped)
        _DUAL_JIT_CACHE[key] = jitted

    def call(qk1, qk2, k_valid):
        return jitted(
            snap.keys, snap.blocks, snap.term_block_start, snap.counts,
            snap.hash_slots,
            dsnap.keys, dsnap.blocks, dsnap.term_block_start, dsnap.counts,
            dsnap.hash_slots,
            qk1, qk2, k_valid,
        )

    return call


def make_sharded_boolean_dual_scatter(
    snap: ShardedSnapshot, dsnap: ShardedSnapshot, L: int, op: str
):
    """make_sharded_boolean_dual with REDUCE-SCATTER query partitioning
    (see make_sharded_boolean_scatter): both tiers' decodes psum_scatter
    over the query axis, so the pair union AND the set op run on each
    device's Q/D tile instead of replicated. Same (out, oc, need) contract;
    Q pads to a device multiple internally."""
    from ..ops import setops

    D = snap.n_devices
    key = ("rs", snap.mesh, L, op, snap.max_probes, dsnap.max_probes)
    probes1, probes2 = snap.max_probes, dsnap.max_probes
    jitted = _DUAL_JIT_CACHE.get(key)
    if jitted is None:
        def _rs(x):
            return jax.lax.psum_scatter(
                x, SHARD_AXIS, scatter_dimension=0, tiled=True
            )

        def step(k1, b1, t1, c1, s1, k2, b2, t2, c2, s2, qk1, qk2, k_valid):
            Q, K, W1 = qk1.shape
            Qd = Q // D
            f1, v1, n1, r1 = _local_lookup(
                k1, b1, t1, c1, s1, qk1.reshape(Q * K, W1), L, probes1)
            v1 = _rs(v1.reshape(Q, K * L)).reshape(Qd * K, L)
            n1 = _rs(n1.reshape(Q, K)).reshape(Qd * K)
            r1 = _rs(r1.reshape(Q, K))
            f2, v2, n2, r2 = _local_lookup(
                k2, b2, t2, c2, s2, qk2.reshape(Q * K, qk2.shape[-1]), L,
                probes2)
            v2 = _rs(v2.reshape(Q, K * L)).reshape(Qd * K, L)
            n2 = _rs(n2.reshape(Q, K)).reshape(Qd * K)
            r2 = _rs(r2.reshape(Q, K))
            pair = jnp.stack([v1, v2], axis=1)                  # (QdK, 2, L)
            pcnt = jnp.stack([n1, n2], axis=1)
            u, uc = setops.union_many(
                pair, pcnt, jnp.full((Qd * K,), 2, jnp.int32))
            lists = u.reshape(Qd, K, 2 * L)
            ncnt = uc.reshape(Qd, K)
            i0 = jax.lax.axis_index(SHARD_AXIS) * Qd
            kv = jax.lax.dynamic_slice_in_dim(k_valid, i0, Qd)
            kmask = jnp.arange(K, dtype=jnp.int32)[None, :] < kv[:, None]
            need = jnp.max(
                jnp.where(kmask, r1 + r2, 0), axis=1
            ).astype(jnp.int32)
            if op == "and":
                out, oc = setops.intersect_many(lists, ncnt, kv)
            else:
                out, oc = setops.union_many(lists, ncnt, kv)
            return out, oc, need

        mapped = shard_map(
            step,
            mesh=snap.mesh,
            in_specs=(P(SHARD_AXIS),) * 10 + (P(), P(), P()),
            out_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS)),
        )
        jitted = jax.jit(mapped)
        _DUAL_JIT_CACHE[key] = jitted

    def call(qk1, qk2, k_valid):
        Q = qk1.shape[0]
        Qp = -(-Q // D) * D
        if Qp != Q:
            pad = lambda a: jnp.concatenate(
                [a, jnp.zeros((Qp - Q, *a.shape[1:]), a.dtype)]
            )
            qk1, qk2, k_valid = pad(qk1), pad(qk2), pad(k_valid)
        out, oc, need = jitted(
            snap.keys, snap.blocks, snap.term_block_start, snap.counts,
            snap.hash_slots,
            dsnap.keys, dsnap.blocks, dsnap.term_block_start, dsnap.counts,
            dsnap.hash_slots,
            qk1, qk2, k_valid,
        )
        if Qp != Q:
            out, oc, need = out[:Q], oc[:Q], need[:Q]
        return out, oc, need

    return call


def make_sharded_boolean_concat(snap: ShardedSnapshot, SB: int, op: str):
    """Concat-decode boolean over the mesh (the exact-any-length formulation
    of ops/concat_bool.py, distributed): each device resolves and decodes
    ONLY the terms it owns into its (Q, SB*128) concat slice, the slices
    are all_gathered, and the run-length reduction (AND: run == k_valid;
    OR: run starts) runs replicated on the (Q, D*SB*128) sorted concat.

    SB: per-DEVICE total-block budget (every device's owned blocks for one
    query must fit). Exact for any posting length — no truncation signal
    needed, unlike make_sharded_boolean's padded-L formulation.
    Returns call(qkeys (Q,K,W+1), k_valid (Q,)) -> (out (Q, S_out), oc).
    """
    _ck = ("bool_concat", SB, op)
    if _ck in snap._jit_cache:
        return snap._jit_cache[_ck]
    from ..ops import concat_bool as cb
    from ..ops import dict_search as ds
    from ..ops.decode import decode_blocks_ba

    probes = snap.max_probes
    D = snap.mesh.shape[SHARD_AXIS]
    BLOCK = 128

    def step(keys, blocks, tbs_arr, counts, slots, qkeys, k_valid):
        Q, K, Wp1 = qkeys.shape
        flat = qkeys.reshape(Q * K, Wp1)
        idx, found = ds.hash_lookup_rows(keys[0], slots[0], flat, probes)
        idx = idx.reshape(Q, K)
        found = found.reshape(Q, K)
        kmask = jnp.arange(K, dtype=jnp.int32)[None, :] < k_valid[:, None]
        live = found & kmask
        cnt = jnp.where(live, counts[0][idx], 0)
        rows, in_use, bit, cnt_j, cum = cb.concat_layout(tbs_arr[0][idx], cnt, SB)
        local, vals, mask = cb.decode_masked(blocks[0], rows, in_use, bit, cnt_j)

        # all_gather every device's slice; replicated reduction
        gathered = jax.lax.all_gather(local, SHARD_AXIS)      # (D, Q, S_loc)
        S = D * SB * BLOCK
        svals = jnp.sort(jnp.moveaxis(gathered, 0, 1).reshape(Q, S), axis=1)
        first = jnp.concatenate(
            [jnp.ones((Q, 1), dtype=bool), svals[:, 1:] != svals[:, :-1]], axis=1
        )
        # genuine 0xFFFFFFFF members: each OWNER tests its terms' last values;
        # psum counts how many of the query's terms contain it mesh-wide
        has_ff_local = (cnt > 0) & (cb.last_values(vals, cum, cnt) == cb.SENTINEL)
        ff_cnt = jax.lax.psum(
            jnp.sum(has_ff_local.astype(jnp.int32), axis=1), SHARD_AXIS
        )
        if op == "and":
            keep = cb.run_reaches_k(svals, k_valid, K) & first & (svals != cb.SENTINEL)
            n_found = jax.lax.psum(jnp.sum(live.astype(jnp.int32), axis=1), SHARD_AXIS)
            ff_all = (ff_cnt == k_valid) & (k_valid > 0)
            # a required term found nowhere voids the AND (run-length already
            # handles the non-ff values; this guards the ff shortcut)
            ff_all &= n_found == k_valid
            oc = (jnp.sum(keep, axis=1) + ff_all.astype(jnp.int32)).astype(jnp.int32)
        else:
            # pads sort last; a genuine ff at the count boundary is
            # count-interchangeable (union_many convention)
            keep = first & (svals != cb.SENTINEL)
            oc = (jnp.sum(keep, axis=1) + (ff_cnt > 0).astype(jnp.int32)).astype(jnp.int32)
        out = jnp.sort(jnp.where(keep, svals, cb.SENTINEL), axis=1)
        return out, oc

    mapped = shard_map(
        step,
        mesh=snap.mesh,
        in_specs=(P(SHARD_AXIS),) * 5 + (P(), P()),
        out_specs=(P(), P()),
        # outputs ARE replicated (they derive from all_gather + psum), but
        # the static replication checker can't see through the mixed flow
        check_vma=False,
    )
    jitted = jax.jit(mapped)

    def call(qkeys, k_valid):
        return jitted(
            snap.keys, snap.blocks, snap.term_block_start, snap.counts,
            snap.hash_slots, qkeys, k_valid,
        )

    snap._jit_cache[_ck] = call
    return call


def make_sharded_boolean_concat_scatter(snap: ShardedSnapshot, SB: int, op: str):
    """make_sharded_boolean_concat with the reduction QUERY-SHARDED: the
    per-device concat slices exchange with an all_to_all over the query
    axis (device d receives every device's slice for its Q/D query tile —
    same wire volume as the all_gather divided by D), so the (Q, D*SB*128)
    sort + run-length reduction runs once per query across the mesh instead
    of replicated on every device. Same exactness and call contract as the
    replicated form; Q pads to a device multiple internally."""
    _ck = ("bool_concat_rs", SB, op)
    if _ck in snap._jit_cache:
        return snap._jit_cache[_ck]
    from ..ops import concat_bool as cb
    from ..ops import dict_search as ds

    probes = snap.max_probes
    D = snap.mesh.shape[SHARD_AXIS]
    BLOCK = 128

    def step(keys, blocks, tbs_arr, counts, slots, qkeys, k_valid):
        Q, K, Wp1 = qkeys.shape
        Qd = Q // D
        flat = qkeys.reshape(Q * K, Wp1)
        idx, found = ds.hash_lookup_rows(keys[0], slots[0], flat, probes)
        idx = idx.reshape(Q, K)
        found = found.reshape(Q, K)
        kmask = jnp.arange(K, dtype=jnp.int32)[None, :] < k_valid[:, None]
        live = found & kmask
        cnt = jnp.where(live, counts[0][idx], 0)
        rows, in_use, bit, cnt_j, cum = cb.concat_layout(tbs_arr[0][idx], cnt, SB)
        local, vals, mask = cb.decode_masked(blocks[0], rows, in_use, bit, cnt_j)

        # query tile exchange: device d receives all slices of its Q/D tile
        tile = jax.lax.all_to_all(
            local, SHARD_AXIS, split_axis=0, concat_axis=1, tiled=True
        )                                                     # (Qd, D*S_loc)
        S = D * SB * BLOCK
        svals = jnp.sort(tile.reshape(Qd, S), axis=1)
        first = jnp.concatenate(
            [jnp.ones((Qd, 1), dtype=bool), svals[:, 1:] != svals[:, :-1]], axis=1
        )
        i0 = jax.lax.axis_index(SHARD_AXIS) * Qd
        kv = jax.lax.dynamic_slice_in_dim(k_valid, i0, Qd)
        # ff / found counts reduce mesh-wide (per query), then tile-slice
        has_ff_local = (cnt > 0) & (cb.last_values(vals, cum, cnt) == cb.SENTINEL)
        ff_cnt = jax.lax.psum(
            jnp.sum(has_ff_local.astype(jnp.int32), axis=1), SHARD_AXIS
        )
        ff_cnt = jax.lax.dynamic_slice_in_dim(ff_cnt, i0, Qd)
        if op == "and":
            keep = cb.run_reaches_k(svals, kv, K) & first & (svals != cb.SENTINEL)
            n_found = jax.lax.psum(jnp.sum(live.astype(jnp.int32), axis=1), SHARD_AXIS)
            n_found = jax.lax.dynamic_slice_in_dim(n_found, i0, Qd)
            ff_all = (ff_cnt == kv) & (kv > 0)
            ff_all &= n_found == kv
            oc = (jnp.sum(keep, axis=1) + ff_all.astype(jnp.int32)).astype(jnp.int32)
        else:
            keep = first & (svals != cb.SENTINEL)
            oc = (jnp.sum(keep, axis=1) + (ff_cnt > 0).astype(jnp.int32)).astype(jnp.int32)
        out = jnp.sort(jnp.where(keep, svals, cb.SENTINEL), axis=1)
        return out, oc

    mapped = shard_map(
        step,
        mesh=snap.mesh,
        in_specs=(P(SHARD_AXIS),) * 5 + (P(), P()),
        out_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
        check_vma=False,
    )
    jitted = jax.jit(mapped)

    def call(qkeys, k_valid):
        Q = qkeys.shape[0]
        Qp = -(-Q // D) * D
        if Qp != Q:
            qkeys = jnp.concatenate(
                [qkeys, jnp.zeros((Qp - Q, *qkeys.shape[1:]), qkeys.dtype)]
            )
            k_valid = jnp.concatenate(
                [k_valid, jnp.zeros(Qp - Q, dtype=k_valid.dtype)]
            )
        out, oc = jitted(
            snap.keys, snap.blocks, snap.term_block_start, snap.counts,
            snap.hash_slots, qkeys, k_valid,
        )
        if Qp != Q:
            out, oc = out[:Q], oc[:Q]
        return out, oc

    snap._jit_cache[_ck] = call
    return call


def make_sharded_prefix_ranges(snap: ShardedSnapshot):
    """Compile the fan-out prefix range search: every device resolves each
    prefix to its LOCAL dictionary span [lo, hi) (two batched key searches —
    the mesh analogue of PrefixSearch's per-shard scan start,
    inverted_index.go:239-285). Returns (lo (D, P), hi (D, P)) to the host;
    pad rows sort after every real term and any hi-key, so spans never
    include padding."""
    _ck = ("prefix_ranges",)
    if _ck in snap._jit_cache:
        return snap._jit_cache[_ck]
    from ..models import query_engine as qe

    def step(keys, lo_keys, hi_keys):
        lo, hi = qe.prefix_range_step(keys[0], lo_keys, hi_keys)
        return lo[None, :], hi[None, :]

    mapped = shard_map(
        step,
        mesh=snap.mesh,
        in_specs=(P(SHARD_AXIS), P(), P()),
        out_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
    )
    jitted = jax.jit(mapped)

    def call(lo_keys, hi_keys):
        return jitted(snap.keys, lo_keys, hi_keys)

    snap._jit_cache[_ck] = call
    return call


def make_sharded_decode(snap: ShardedSnapshot, L: int):
    """Compile a device-LOCAL decode-by-index step: each device decodes rows
    `idx[d]` of ITS partition into (D, M, L) padded posting rows + raw
    counts. No collective — results stay sharded and the host reads the
    slices it needs (prefix unions, range reads)."""
    _ck = ("decode", L)
    if _ck in snap._jit_cache:
        return snap._jit_cache[_ck]
    from ..ops import decode as dec

    def step(blocks, tbs, counts, idx):
        vals, raw = dec.gather_postings_arena(blocks[0], tbs[0], counts[0], idx[0], L)
        return vals[None], raw[None]

    mapped = shard_map(
        step,
        mesh=snap.mesh,
        in_specs=(P(SHARD_AXIS),) * 4,
        out_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
    )
    jitted = jax.jit(mapped)

    def call(idx):
        return jitted(snap.blocks, snap.term_block_start, snap.counts, idx)

    snap._jit_cache[_ck] = call
    return call


def _prefix_keys(prefixes, width: int):
    from ..codec import keys as keys_mod

    Wp1 = width + 1
    lo_k = keys_mod.pack_terms(list(prefixes), width=width)
    hi_k = np.zeros((len(prefixes), Wp1), dtype=np.uint32)
    for i, p in enumerate(prefixes):
        padded = p + b"\xff" * (width * 4 - len(p))
        hi_k[i] = keys_mod.pack_one(padded[: width * 4], width)
        hi_k[i, -1] = 0xFFFFFFFF
    return lo_k, hi_k


def _decode_spans(snap: ShardedSnapshot, spans, L: int = 1024):
    """Exactly decode the rows of each span; spans: [(device, lo, hi), ...].

    Returns a list (per span) of lists of value arrays, IN ROW ORDER. Rows
    are ladder-grouped by their true counts (fetched to host per span — a
    few KB) so long posting lists are exact, mirroring the single-chip
    QueryEngine; device batches run through the sharded local-decode step.
    """
    from ..models.query_engine import _RESERVE_BUDGET, _ladder

    D = snap.n_devices
    results = [[None] * max(0, hi - lo) for d, lo, hi in spans]
    levels = np.array([L] + _ladder(L, snap.max_count), dtype=np.int64)
    # per-device work items: (partition row, span index, row-in-span, count)
    work = {d: [] for d in range(D)}
    for si, (d, lo, hi) in enumerate(spans):
        if hi <= lo:
            continue
        cnts = np.asarray(snap.counts[d, lo:hi]).astype(np.int64)
        for r in range(hi - lo):
            work[d].append((lo + r, si, r, int(cnts[r])))
    by_level = {}
    for d, items in work.items():
        for it in items:
            lv = int(levels[int(np.searchsorted(levels, max(1, it[3])))])
            by_level.setdefault(lv, {}).setdefault(d, []).append(it)
    for lv, dev_items in sorted(by_level.items()):
        dec = make_sharded_decode(snap, lv)
        M = max(len(v) for v in dev_items.values())
        qb = max(8, _RESERVE_BUDGET // lv)
        for c0 in range(0, M, qb):
            B = min(qb, M - c0)
            batch = np.zeros((D, B), dtype=np.int32)
            meta = {}
            for d, items in dev_items.items():
                part = items[c0 : c0 + B]
                for j, (idx, si, r, c) in enumerate(part):
                    batch[d, j] = idx
                meta[d] = part
            vals, _raw = dec(jnp.asarray(batch))
            vals = np.asarray(vals)
            for d, part in meta.items():
                for j, (idx, si, r, c) in enumerate(part):
                    results[si][r] = vals[d, j, : min(c, lv)].copy()
    return results


def sharded_prefix_search(snap: ShardedSnapshot, prefixes, L: int = 1024):
    """PrefixSearch over the mesh: device range resolution on every
    partition (fan-out), device-local ladder decode, host union. Unmatched
    prefixes absent; values sorted unique (parity with
    InvertedIndex.prefix_search, inverted_index.go:192-295)."""
    if not prefixes:
        return {}
    lo_k, hi_k = _prefix_keys(prefixes, snap.width)
    ranges = make_sharded_prefix_ranges(snap)
    lo, hi = ranges(jnp.asarray(lo_k), jnp.asarray(hi_k))
    lo, hi = np.asarray(lo), np.asarray(hi)
    spans, span_prefix = [], []
    for i, p in enumerate(prefixes):
        for d in range(snap.n_devices):
            if hi[d, i] > lo[d, i]:
                spans.append((d, int(lo[d, i]), int(hi[d, i])))
                span_prefix.append(i)
    decoded = _decode_spans(snap, spans, L)
    out = {}
    for i, p in enumerate(prefixes):
        parts = [
            row
            for si, rows in enumerate(decoded)
            if span_prefix[si] == i
            for row in rows
        ]
        if parts:
            out[p] = np.unique(np.concatenate(parts))
    return out


def sharded_read_range(snap: ShardedSnapshot, min_term=None, max_term=None, L: int = 1024):
    """Globally sorted (term, values) stream over the mesh, [min,max]
    inclusive. Device partitions are contiguous shard-key ranges, so global
    order = device order (the concatenation invariant of
    inverted_index.go:303-339); each device's span resolves and decodes
    locally. NOTE: partitions split by SHARD KEY, so terms shorter than two
    bytes (routed to shard 0 regardless of bytes) can yield out of byte
    order across devices — same caveat as the reference's shard
    concatenation."""
    from ..codec import keys as keys_mod

    lo_k, hi_k = _read_range_keys(snap, min_term, max_term)
    ranges = make_sharded_prefix_ranges(snap)
    lo, hi = ranges(jnp.asarray(lo_k), jnp.asarray(hi_k))
    lo, hi = np.asarray(lo), np.asarray(hi)
    for d in range(snap.n_devices):
        a, b = int(lo[d, 0]), int(hi[d, 0])
        if b <= a:
            continue
        kr = np.asarray(snap.keys[d, a:b])
        blob, offs = keys_mod.unpack_keys(kr)
        rows = _decode_spans(snap, [(d, a, b)], L)[0]
        for j in range(b - a):
            yield blob[offs[j] : offs[j + 1]].tobytes(), rows[j]


def _read_range_keys(snap: ShardedSnapshot, min_term, max_term):
    """[min, max] inclusive -> one (lo_key, hi_key) search pair.

    hi_key sorts strictly after max_term but before any term extending it
    (same bytes, longer): pack(max_term) with the length word bumped by one.
    """
    from ..codec import keys as keys_mod

    W = snap.width
    if min_term is None:
        lo_k = np.zeros((1, W + 1), dtype=np.uint32)
    else:
        lo_k = keys_mod.pack_terms([min_term], width=W)
    if max_term is None:
        hi_k = np.full((1, W + 1), _PAD_WORD, dtype=np.uint32)  # first pad row
    else:
        hi_k = keys_mod.pack_terms([max_term], width=W)
        hi_k[0, -1] += 1
    return lo_k, hi_k


def partition_stats(snap: ShardedSnapshot) -> dict:
    """Skew report: per-device real term AND block-row counts vs the
    padded (Nmax, Bmax).

    Partitions pad to the LARGEST device's term count and block count, so
    an uneven split wastes HBM proportional to max/mean — blocks are the
    HBM-dominant table (arena rows are stride words each), which is why
    balanced_ranges cuts on block volume by default."""
    keys = np.asarray(snap.keys[:, :, -1])
    n_real = (keys != _PAD_WORD).sum(axis=1)
    nmax = int(snap.keys.shape[1])
    # real arena rows per device = the last real term's block end
    tbs = np.asarray(snap.term_block_start)
    b_real = np.array(
        [int(tbs[d, int(n_real[d])]) for d in range(snap.n_devices)],
        dtype=np.int64,
    )
    bmax = int(snap.blocks.shape[1])  # (D, Bmax, stride)
    return {
        "n_terms_per_device": n_real.tolist(),
        "padded_to": nmax,
        "padding_overhead": round(float(nmax * snap.n_devices / max(1, n_real.sum())), 3),
        "blocks_per_device": b_real.tolist(),
        "blocks_padded_to": bmax,
        "block_padding_overhead": round(
            float(bmax * snap.n_devices / max(1, b_real.sum())), 3
        ),
    }


def default_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (SHARD_AXIS,))
