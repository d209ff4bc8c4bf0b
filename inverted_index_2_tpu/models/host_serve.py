"""Host-side full-result serving (the retained-tables routes) — a mixin
behind the QueryEngine facade.

Full-result lookups are fetch-volume bound on ANY host<->device link
(results are O(sum of posting lengths); the device adds no compute value
to a raw decode). With the compact host tables retained (keep_tables),
lookups serve entirely host-side: hash probe (codec/hashing.probe_rows_np)
+ native block decode from the SAME compressed stream the device arena
expands from — the reference's mmap-read architecture
(/root/reference/reader.go:33-103) with a columnar contract. The routing
policy that picks between this and the device pipeline stays on
QueryEngine (_host_boolean_route).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # circular at runtime: query_engine imports this mixin
    from .query_engine import ServingState

from ..codec import hashing
from ..codec import keys as keys_mod
from ..codec import native as _native
from ..codec import packing
from .snapshot import HostTables
from .steps import _narrow_keys, _rows_to_columnar


def _fanout_columnar(uvals: np.ndarray, uvoffs: np.ndarray,
                     gid: np.ndarray):
    """Expand a deduped columnar result (uvals, uvoffs) back to the full
    batch through the query->group map: output row i is group gid[i]'s
    row. Native path is one memcpy per row (tpi_fanout_u32) — the
    obligatory output write IS the whole duplicate cost. The numpy
    fallback is a slice-copy loop, NOT a flat fancy gather: at the
    config-3 OR shape (8192 queries x ~5k values) the gather's int64
    index array alone is 2x the output bytes."""
    ucnt = np.diff(uvoffs)
    counts = ucnt[gid]
    voffs = np.zeros(len(gid) + 1, dtype=np.int64)
    np.cumsum(counts, out=voffs[1:])
    out = np.empty(int(voffs[-1]), dtype=uvals.dtype)
    if _native.available() and uvals.dtype == np.uint32:
        _native.fanout_u32(uvals, uvoffs, gid, out, voffs)
    else:
        for i in range(len(gid)):
            g = gid[i]
            out[voffs[i]: voffs[i + 1]] = uvals[uvoffs[g]: uvoffs[g + 1]]
    return out, voffs


class HostServingMixin:
    """Host-route serving methods; mixed into QueryEngine."""

    def host_ready(self) -> bool:
        """True when host-side serving covers the CURRENT tier pair (tables
        retained, and the delta tier — if live — retained too)."""
        return self._state.host_ready()

    @staticmethod
    def _host_decode(t: HostTables, idx: np.ndarray):
        """Decode posting lists for term indexes `idx` (all >= 0) from the
        retained compressed stream. List i's count word sits one word before
        its first block (layout: [n][blocks...], codec/packing.py:11-33;
        flat[tbs[i]] is the first block's offset)."""
        starts = t.flat[t.tbs[:-1].astype(np.int64)[idx]].astype(np.int64) - 1
        values, _, voffs = packing.decode_bulk(t.words, starts)
        return values, voffs

    @staticmethod
    def _filter_sorted_columnar(values, voffs, rem):
        """Drop tombstoned values from a columnar (values, voffs) pair —
        one vectorized searchsorted membership test over the concatenation
        (rem is sorted; removed_list.go:44-54 semantics)."""
        if rem is None or len(rem) == 0 or len(values) == 0:
            return values, voffs
        pos = np.searchsorted(rem, values)
        hit = rem[np.minimum(pos, len(rem) - 1)] == values
        kept = np.zeros(len(values) + 1, dtype=np.int64)
        np.cumsum(~hit, out=kept[1:])
        return values[~hit], kept[voffs]

    def _host_tier_columnar(self, t: HostTables, qk: np.ndarray, rem):
        """One tier's lookup results as (found, values, voffs) — fully
        vectorized: probe, bulk-decode hits (concatenation is already in
        query order), tombstone-filter, re-offset misses to count 0."""
        nq = qk.shape[0]
        if t.n_terms == 0:
            return (np.zeros(nq, bool), np.zeros(0, np.uint32),
                    np.zeros(nq + 1, np.int64))
        idx = hashing.probe_rows_np(
            t.slots, t.max_probes, t.keys, _narrow_keys(qk, t.width)
        )
        found = idx >= 0
        values, hvoffs = self._host_decode(t, idx[found])
        counts = np.zeros(nq, dtype=np.int64)
        counts[found] = np.diff(hvoffs)
        voffs = np.zeros(nq + 1, dtype=np.int64)
        np.cumsum(counts, out=voffs[1:])
        values, voffs = self._filter_sorted_columnar(values, voffs, rem)
        return found, values, voffs

    def _host_tier_starts(self, t: HostTables, qk: np.ndarray) -> np.ndarray:
        """Per-flat-term count-word offsets into t.words (-1 = miss) — the
        resolve half of _host_decode, kept columnar for the fused native
        serve (tpi_boolean_serve decodes from these directly)."""
        nq = qk.shape[0]
        if t.n_terms == 0:
            return np.full(nq, -1, np.int64)
        idx = hashing.probe_rows_np(
            t.slots, t.max_probes, t.keys, _narrow_keys(qk, t.width)
        )
        starts = (
            t.flat[t.tbs[:-1].astype(np.int64)[np.maximum(idx, 0)]]
            .astype(np.int64) - 1
        )
        starts[idx < 0] = -1
        return starts

    def lookup_host(
        self, terms: Sequence[bytes], filter_removed: bool = False
    ) -> List[Optional[np.ndarray]]:
        """lookup() served entirely on host from the retained tables (zero
        device round trips; exact at any posting length — no ladder). Same
        contract: None for misses, per-term sorted postings, delta-tier
        union when an incremental refresh window is live. Requires
        host_ready() (engine built with keep_tables)."""
        if not terms:
            return []
        st = self._state
        if not st.host_ready():
            raise RuntimeError(
                "host serving needs retained tables (keep_tables=True)"
            )
        rem = st.removed_host() if filter_removed else None
        qk = keys_mod.pack_terms(list(terms), width=st.host_q_width())
        found, values, voffs = self._host_tier_columnar(st.tables, qk, rem)
        rows: List[Optional[np.ndarray]] = [
            values[voffs[i] : voffs[i + 1]].copy() if found[i] else None
            for i in range(len(terms))
        ]
        if st.delta is not None:
            f2, v2, o2 = self._host_tier_columnar(st.delta_tables, qk, rem)
            for i in range(len(terms)):
                if not f2[i]:
                    continue
                d = v2[o2[i] : o2[i + 1]]
                rows[i] = d if rows[i] is None else np.union1d(rows[i], d)
        return rows

    def _host_lookup_stream(self, st: ServingState, batches,
                            filter_removed: bool, columnar: bool,
                            prefix_p: int):
        """lookup_staged's host route: per-batch columnar assembly with no
        round trips to pipeline (see lookup_staged for the contract —
        misses surface as count-0 rows here, matching the device stream)."""
        rem = st.removed_host() if filter_removed else None
        P = int(prefix_p)
        W = st.host_q_width()
        out = []
        for b in batches:
            terms = list(b)
            if not terms:
                if columnar:
                    empty = (np.zeros(0, np.uint32), np.zeros(1, np.int64))
                    out.append(empty + (np.zeros(0, np.int64),) if P else empty)
                else:
                    out.append([])
                continue
            qk = keys_mod.pack_terms(terms, width=W)
            _, values, voffs = self._host_tier_columnar(st.tables, qk, rem)
            if st.delta is not None:
                f2, v2, o2 = self._host_tier_columnar(
                    st.delta_tables, qk, rem
                )
                if f2.any():
                    rows = [values[voffs[i] : voffs[i + 1]]
                            for i in range(len(terms))]
                    for i in np.nonzero(f2)[0]:
                        rows[i] = np.union1d(rows[i], v2[o2[i] : o2[i + 1]])
                    values, voffs = _rows_to_columnar(rows)
            counts = np.diff(voffs)
            if P:
                rid = np.searchsorted(
                    voffs, np.arange(len(values)), side="right"
                ) - 1
                keep = (np.arange(len(values)) - voffs[rid]) < P
                pvoffs = np.zeros(len(counts) + 1, dtype=np.int64)
                np.cumsum(np.minimum(counts, P), out=pvoffs[1:])
                out.append((values[keep], pvoffs, counts))
            elif columnar:
                out.append((values, voffs))
            else:
                out.append([
                    values[voffs[i] : voffs[i + 1]].copy()
                    for i in range(len(terms))
                ])
        return out

    def boolean_host(
        self, queries: Sequence[Sequence[bytes]], op: str,
        filter_removed: bool = False, _st: Optional[ServingState] = None,
    ) -> List[np.ndarray]:
        """boolean() served entirely on host from the retained tables —
        zero device round trips, exact at any posting length (no ladder).
        Same contract as boolean(): sorted-unique arrays; a missing term
        empties an AND and contributes nothing to an OR; delta-tier rows
        union per term before the set op (boolean_step_dual semantics).

        This is the right route when the op is OUTPUT-bound (a full-result
        OR ships O(sum of posting lengths) no matter who computes it, so on
        a bandwidth-bound host<->device link not crossing it wins) and for
        one-shot dispatch-latency-bound calls on a slow link (non-staged
        AND). The staged AND stream stays device-routed by default — see
        _host_boolean_route for the measured policy."""
        if op not in ("and", "or"):
            raise ValueError(f"op must be 'and' or 'or', got {op!r}")
        st = _st if _st is not None else self._state
        if not st.host_ready():
            raise RuntimeError(
                "host serving needs retained tables (keep_tables=True)"
            )
        if not queries:
            return []
        values, voffs = self._boolean_host_columnar(
            queries, op, filter_removed, st=st
        )
        return [
            values[voffs[i] : voffs[i + 1]].copy()
            for i in range(len(queries))
        ]

    def _boolean_host_columnar(self, queries, op: str, filter_removed: bool,
                               st: Optional[ServingState] = None):
        """boolean_host's columnar core: (values, voffs) over one batch.
        The set-op sweep runs in the native codec (tpi_boolean_host: linear
        merge unions / galloping intersections over the batch-decoded runs —
        the reference's streaming-iterator composition, types.go:14-22, as
        one C++ pass) with the numpy loop kept as the bit-identical fallback
        oracle (tests force it via TPI_DISABLE_NATIVE)."""
        st = st if st is not None else self._state
        if isinstance(queries, tuple) and len(queries) == 3:
            # columnar (blob, offsets, qoffs) batch: pack straight off the
            # wire form — no per-query Python lists (same fast path as
            # _pack_boolean_cols on the device side)
            blob, offsets, qoffs = queries
            blob8 = (
                np.frombuffer(blob, dtype=np.uint8)
                if isinstance(blob, (bytes, bytearray))
                else np.asarray(blob, dtype=np.uint8)
            )
            offsets = np.asarray(offsets, dtype=np.int64)
            koffs = np.asarray(qoffs, dtype=np.int64)
            if len(offsets) <= 1:
                return np.zeros(0, np.uint32), koffs.astype(np.int64) * 0
            qk = keys_mod.pack_blob(blob8, offsets, st.host_q_width())
        else:
            flat_terms = [t for q in queries for t in q]
            koffs = np.zeros(len(queries) + 1, dtype=np.int64)
            np.cumsum([len(q) for q in queries], out=koffs[1:])
            if not flat_terms:
                return np.zeros(0, np.uint32), koffs * 0
            qk = keys_mod.pack_terms(flat_terms, width=st.host_q_width())
        dd = self._host_dedup_group(qk, koffs, op)
        if dd is not None:
            # cross-query dedup on the host route (the one serving
            # full-result OR, the output-bound op): serve each distinct
            # (term-sequence) query once, fan the columnar results back out
            # with one vectorized gather. A duplicate query is the same pure
            # function of (state, query), so fan-out is bit-identical; a dup
            # costs ~the output copy instead of the full decode + k-way
            # union.
            qk_u, koffs_u, gid = dd
            uvals, uvoffs = self._host_serve_columnar(qk_u, koffs_u, op,
                                                      filter_removed, st)
            return _fanout_columnar(uvals, uvoffs, gid)
        return self._host_serve_columnar(qk, koffs, op, filter_removed, st)

    def _host_dedup_group(self, qk: np.ndarray, koffs: np.ndarray, op: str):
        """Group identical queries in a packed host batch. Returns
        (qk_u, koffs_u, gid) — unique queries in first-occurrence order plus
        the query->group map — or None when dedup does not pay: fewer than
        256 queries, TPI_HOST_DEDUP=0, or the estimated serve saving
        (removed queries x per-query serve cost) under ~2x the grouping
        cost. Exactness matches _dedup_batch: the 64-bit row hash only
        MERGES candidate groups and the adjacent full-row verify re-splits
        them, so grouping never conflates distinct queries.

        Unlike the device stream's fixed-K rows, host queries are ragged
        (k varies 1..8+); each query canonicalizes to one padded int64 row
        [k, key words..., 0-pad] — zero-padding cannot collide because k
        leads the row (~2.7 MB for an 8192x8-term batch)."""
        nq = len(koffs) - 1
        mode = os.environ.get("TPI_HOST_DEDUP", "1")
        if mode == "0" or nq < 256:
            return None
        k = np.diff(koffs)
        mk = int(k.max()) if nq else 0
        Wc = qk.shape[1]
        M = np.zeros((nq, 1 + mk * Wc), dtype=np.int64)
        M[:, 0] = k
        T = qk.shape[0]
        if T:
            qidx = np.repeat(np.arange(nq), k)
            tpos = np.arange(T) - np.repeat(koffs[:-1], k)
            cols = 1 + tpos[:, None] * Wc + np.arange(Wc)[None, :]
            M[qidx[:, None], cols] = qk.astype(np.int64)
        mults = self._dedup_mults(M.shape[1])
        h = M @ mults
        nu_h = len(np.unique(h))
        saved = nq - nu_h
        # benefit gate (same shape as _dedup_batch's): saved queries x
        # per-query serve cost must clear ~2x the ~2 ms grouping + fan-out
        # overhead. Assumed host serve costs per query: OR 12 us
        # (decode+union+output), AND 3 us (block-skip intersect).
        cost_us = 12.0 if op == "or" else 3.0
        if mode != "force" and saved * cost_us < 2 * 2000.0:
            return None
        order = np.argsort(h, kind="stable")
        sm = M[order]
        neq = np.empty(nq, dtype=bool)
        neq[0] = True
        np.any(sm[1:] != sm[:-1], axis=1, out=neq[1:])
        nu = int(neq.sum())
        if nu >= nq:
            return None  # hash dups were collisions; nothing to save
        first = order[neq]
        gidx = np.cumsum(neq) - 1
        gid = np.empty(nq, dtype=np.int64)
        gid[order] = gidx
        ku = k[first]
        koffs_u = np.zeros(nu + 1, dtype=np.int64)
        np.cumsum(ku, out=koffs_u[1:])
        tidx = (
            np.repeat(koffs[:-1][first], ku)
            + np.arange(koffs_u[-1])
            - np.repeat(koffs_u[:-1], ku)
        )
        return qk[tidx], koffs_u, gid

    def _host_serve_columnar(self, qk: np.ndarray, koffs: np.ndarray,
                             op: str, filter_removed: bool,
                             st: ServingState):
        """The packed serve core behind _boolean_host_columnar (native
        fused serve + numpy oracle fallback), operating on an already
        packed (qk, koffs) batch."""
        rem = st.removed_host() if filter_removed else None
        dual = st.delta is not None
        if _native.available():
            # fused native serve: decode + set op + tombstone filter run in
            # one pass per query DIRECTLY on the compressed streams — no
            # batch-wide decode ever materializes, AND walks lists smallest-
            # first with block-skip streaming intersection + early exit
            s1 = self._host_tier_starts(st.tables, qk)
            if dual:
                s2 = self._host_tier_starts(st.delta_tables, qk)
                return _native.boolean_serve(
                    st.tables.words, s1, st.delta_tables.words, s2,
                    koffs, rem, op == "or",
                )
            return _native.boolean_serve(
                st.tables.words, s1, None, None, koffs, rem, op == "or"
            )
        # numpy fallback: resolve+decode each tier ONCE for the whole batch
        # (columnar); tombstones filter the per-query RESULT, not the
        # inputs — same outcome, less volume (matches the device
        # filter-after-set-op)
        found, values, voffs = self._host_tier_columnar(
            st.tables, qk, None
        )
        if dual:
            f2, v2, o2 = self._host_tier_columnar(st.delta_tables, qk, None)
        out: List[np.ndarray] = []
        empty = np.zeros(0, np.uint32)
        for qi in range(len(koffs) - 1):
            rows = []
            miss = koffs[qi] == koffs[qi + 1]
            for j in range(koffs[qi], koffs[qi + 1]):
                a = values[voffs[j] : voffs[j + 1]] if found[j] else None
                if dual and f2[j]:
                    d = v2[o2[j] : o2[j + 1]]
                    a = d if a is None else np.union1d(a, d)
                if a is None:
                    miss = True
                    if op == "and":
                        break
                else:
                    rows.append(a)
            if op == "and":
                if miss or not rows:
                    res = empty
                else:
                    rows.sort(key=len)  # smallest-first: early exit on empty
                    res = rows[0]
                    for r in rows[1:]:
                        if len(res) == 0:
                            break
                        res = np.intersect1d(res, r, assume_unique=True)
            else:
                if not rows:
                    res = empty
                elif len(rows) == 1:
                    res = rows[0]
                else:
                    res = np.unique(np.concatenate(rows))
            if rem is not None and len(rem) and len(res):
                pos = np.searchsorted(rem, res)
                hit = rem[np.minimum(pos, len(rem) - 1)] == res
                res = res[~hit]
            out.append(res)
        return _rows_to_columnar(out)

    # link breakevens, set on another accelerator behind a slow remote link
    # and not yet measured on a PCIe-attached card. Full-result OR: the
    # device route is bounded by link bytes (~20 KB per query of output at
    # config-3) while the SIMD host serve moves ZERO link bytes, so the
    # device only wins on a fast link. Non-staged AND: host serve vs a
    # dispatch-latency-bound device round trip — a conservative 256 MB/s,
    # since a fast local link makes the one-shot device path competitive
    # and keeps the host core free.
