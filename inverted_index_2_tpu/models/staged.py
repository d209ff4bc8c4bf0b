"""Depth-pipelined stream serving (staged boolean/lookup) — a mixin
behind the QueryEngine facade.

The staged streams pack + dispatch batch i+depth BEFORE downloading batch
i's results, so host packing and fetch round trips overlap device compute
(see boolean_staged). Split out of models/query_engine.py.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # circular at runtime: query_engine imports this mixin
    from .query_engine import ServingState

import jax
import jax.numpy as jnp

from .steps import (
    _JIT_BOOLEAN_DUAL,
    _JIT_CONCAT_BOOL,
    _JIT_FILTER,
    _JIT_CONCAT_BOOL_SEL,
    _JIT_PACK_P,
    _JIT_RESOLVE,
    _JIT_RESOLVE_SB,
    _JIT_SCATTER_P,
    _JIT_SPLIT_IDX,
    _host_resolve_sb,
    _JIT_TAKE_ROWS,
    _JIT_WIRE_META,
    _JIT_WIRE_PACK,
    _batch_as_lists,
    _dedup_adjacent,
    _narrow_keys,
    _rows_to_columnar,
    _wire_unpack,
    _RESERVE_BUDGET,
    _round_up,
)


class StagedStreamsMixin:
    """Pipelined stream-serving methods; mixed into QueryEngine."""

    def lookup_staged(
        self, batches, filter_removed: bool = False, depth: int = 3,
        columnar: bool = False, prefix_p: int = 0,
    ):
        """Pipelined stream lookup: `batches` is an iterable of term lists.
        Each term serves as a single-term OR query through the staged
        concat-class stream (exact at any posting length — classes size by
        TRUE counts, no ladder, no truncation), so packing, dispatch, and
        the fetch round trips pipeline across batches exactly like
        boolean_staged. Returns per batch what boolean_staged returns
        (rows / columnar pair / pagination triple with prefix_p).

        Misses surface as count-0 results rather than lookup()'s None —
        without filter_removed a PRESENT term always has >= 1 posting, so
        zero is unambiguous there.

        With retained host tables covering the live tier pair (host_ready),
        batches serve entirely HOST-side — native decode from the
        compressed stream, zero device round trips: full-result lookup is
        fetch-volume bound on any link, so not crossing the link at all is
        the speed of light for this op."""
        st = self._state
        if st.host_ready():
            return self._host_lookup_stream(
                st, batches, filter_removed, columnar, prefix_p
            )
        return self.boolean_staged(
            [[[t] for t in b] for b in batches], "or",
            filter_removed, depth, columnar, prefix_p, _st=st,
        )

    def boolean_staged(
        self, batches, op: str = "and", filter_removed: bool = False,
        depth: int = 3, columnar: bool = False, prefix_p: int = 0,
        _st: Optional[ServingState] = None,
    ):
        """Pipelined stream serving: pack + dispatch batch i+`depth` BEFORE
        downloading batch i's results, so host packing and the fetch round
        trip overlap device compute instead of serializing with it —
        steady-state throughput approaches max(device, host) rather than
        their sum. Per-batch semantics are identical to boolean().

        AND and OR (and any prefix_p run) stream through the concat-decode
        classes; with a delta tier live, batches stream through the padded
        DUAL formulation (_staged_dual_stream), which pipelines at the same
        depth and drains ladder re-serves once, cross-stream.

        batches: iterable of query batches — each a sequence of term
        lists, OR a columnar (blob, offsets[T+1], qoffs[Q+1]) triple
        (terms concatenated in one bytes/uint8 buffer; queries as term
        ranges). Columnar input skips the list-of-lists pack's
        Python-object costs — prefer it when queries arrive in wire form.
        columnar=False: one result list (np array per query) per batch.
        columnar=True: one (values, voffs[n+1]) pair per batch — zero
        per-query host work (bulk consumers; values[voffs[i]:voffs[i+1]]
        is query i's sorted result).
        prefix_p > 0 (requires columnar): pagination serving — each batch
        returns (values, voffs, counts) where values holds only the FIRST
        min(count, prefix_p) results per query and counts the true result
        sizes. Bounds the fetch volume for large-result ops (OR unions are
        O(sum of list lengths); full-result fetches are bandwidth-bound on
        any link). Exact full results for chosen rows come from boolean().
        """
        from collections import deque

        batches = list(batches)
        if prefix_p and not columnar:
            raise ValueError("prefix_p requires columnar=True")
        st = _st if _st is not None else self._state
        if self._host_boolean_route(op, prefix_p, staged=True, st=st):
            # output-bound op with tables retained: the host route has no
            # round trips to pipeline — serve each batch directly.
            # prefix_p reaches here only in the warm-checkpoint window
            # (device_ready=False): full host results slice to the
            # (values, voffs, counts) pagination contract.
            out = []
            for b in batches:
                if columnar:  # columnar core directly: no per-row copies,
                    vals, voffs = self._boolean_host_columnar(
                        b, op, filter_removed, st=st
                    )  # and wire-form batches pack vectorized
                    if prefix_p:
                        counts = np.diff(voffs)
                        rid = np.searchsorted(
                            voffs, np.arange(len(vals)), side="right"
                        ) - 1
                        keep = (np.arange(len(vals)) - voffs[rid]) < prefix_p
                        pvoffs = np.zeros(len(counts) + 1, dtype=np.int64)
                        np.cumsum(np.minimum(counts, prefix_p),
                                  out=pvoffs[1:])
                        out.append((vals[keep], pvoffs, counts))
                    else:
                        out.append((vals, voffs))
                else:
                    out.append(self.boolean_host(
                        _batch_as_lists(b), op, filter_removed, _st=st
                    ))
            return out
        removed = st.removed if filter_removed else None
        if st.delta is not None:
            # delta window: the padded DUAL formulation, still pipelined
            return self._staged_dual_stream(
                st, batches, op, removed, depth, columnar, prefix_p
            )
        if st.snap.n_terms == 0:
            # empty index: per-batch fallback (nothing to pipeline)
            out = []
            for b in batches:
                rows = self.boolean(_batch_as_lists(b), op, filter_removed)
                if not columnar:
                    out.append(rows)
                    continue
                vals, voffs = _rows_to_columnar(
                    [None if r is None else r[:prefix_p] for r in rows]
                    if prefix_p else rows
                )
                if prefix_p:
                    counts = np.array(
                        [0 if r is None else len(r) for r in rows],
                        dtype=np.int64,
                    )
                    out.append((vals, voffs, counts))
                else:
                    out.append((vals, voffs))
            return out
        # exact stream through the pipelined concat classes (also the
        # pagination route: prefix_p slices on device there)
        return self._staged_concat_stream(
            st, batches, op, removed, depth, columnar, prefix_p
        )

    def _staged_dual_stream(
        self, st, batches, op: str, removed, depth: int, columnar: bool,
        prefix_p: int,
    ):
        """Depth-pipelined stream over the MAIN+DELTA snapshot pair (the
        padded dual formulation, boolean_step_dual): dispatches pipeline
        across batches and ladder re-serves drain once cross-stream
        (two-wave), so serving throughput holds through delta windows
        instead of dropping to serial per-batch calls. prefix_p slices
        each result row on device at dispatch time (true counts + first-P
        values, one bounded fetch — the pagination contract)."""
        from collections import deque

        s, d = st.snap, st.delta
        P = int(prefix_p)
        fetched: List = [None] * len(batches)
        longs = []
        pend = deque()

        def run(lv, qk_sub, kv_sub):
            return _JIT_BOOLEAN_DUAL(
                s.keys, s.blocks, s.term_block_start, s.counts, s.hash_slots,
                d.keys, d.blocks, d.term_block_start, d.counts, d.hash_slots,
                jnp.asarray(_narrow_keys(qk_sub, s.width)),
                jnp.asarray(_narrow_keys(qk_sub, d.width)),
                jnp.asarray(kv_sub), lv, op, removed,
                s.max_probes, d.max_probes,
            )

        def harvest(item):
            bi, nq, qk, kv, out, oc, need = item
            oc_h, need_h = jax.device_get((oc, need))
            if P:
                out_h = np.asarray(out)  # the (Q, P) device slice
            else:
                out_h = np.asarray(
                    out[:, : max(1, int(oc_h[:nq].max(initial=0)))]
                )
            fetched[bi] = (nq, out_h, oc_h)
            for i in np.nonzero(need_h[:nq] > self.L)[0]:
                longs.append((
                    (bi, int(i)), qk[i], int(kv[i]),
                    self._level_for(int(need_h[i]), st),
                ))

        for bi, queries in enumerate(batches):
            nq, qk, kv = self._batch_pack(st, queries)
            if nq == 0:
                fetched[bi] = (0, None, None)
                continue
            out, oc, need = run(self.L, qk, kv)
            if P:
                out = out[:, : min(P, out.shape[1])]
                out.copy_to_host_async()
            oc.copy_to_host_async()
            need.copy_to_host_async()
            pend.append((bi, nq, qk, kv, out, oc, need))
            if len(pend) > depth:
                harvest(pend.popleft())
        while pend:
            harvest(pend.popleft())

        overrides: Dict[int, Dict[int, np.ndarray]] = {}

        def setter(pos, v):
            overrides.setdefault(pos[0], {})[pos[1]] = v

        self._drain_levels(longs, run, setter)

        results = []
        for bi in range(len(batches)):
            nq, out_h, oc_h = fetched[bi]
            if nq == 0:
                if columnar:
                    empty = (np.zeros(0, np.uint32), np.zeros(1, np.int64))
                    results.append(
                        empty + (np.zeros(0, np.int64),) if P else empty
                    )
                else:
                    results.append([])
                continue
            ovr = overrides.get(bi, {})
            if P:
                counts = oc_h[:nq].astype(np.int64)
                rows = []
                for i in range(nq):
                    if i in ovr:
                        counts[i] = len(ovr[i])
                        rows.append(ovr[i][:P])
                    else:
                        rows.append(out_h[i, : min(int(oc_h[i]), P)])
                vals, voffs = _rows_to_columnar(rows)
                results.append((vals, voffs, counts))
            else:
                rows = [
                    ovr[i] if i in ovr else out_h[i, : oc_h[i]].copy()
                    for i in range(nq)
                ]
                results.append(_rows_to_columnar(rows) if columnar else rows)
        return results

    def _staged_concat_stream(
        self, st, batches, op: str, removed, depth: int, columnar: bool,
        prefix_p: int,
    ):
        """Depth-pipelined stream serving over the concat-decode classes
        (AND, OR, and prefix_p pagination). Three stages per batch,
        each overlapping the others' device time across the stream:

          resolve:  pack + dispatch the cheap term-resolution pass
          classes:  read the counts, group queries into total-block classes,
                    dispatch every class chunk (async) + start the result
                    copies
          harvest:  fetch counts (+ trimmed results, or the prefix_p slice),
                    assemble per-batch output

        prefix_p=0 fetches exact full results (two round trips per batch —
        counts gate the trim; OR unions are O(total postings), so the fetch
        itself is the floor on any link). prefix_p>0 slices each result row
        to prefix_p ON DEVICE at dispatch time, so the harvest is ONE
        bounded fetch regardless of union sizes and the batch returns
        (values, voffs, true_counts) — the pagination contract documented
        on boolean_staged."""
        from collections import deque

        s = st.snap
        stride = int(s.blocks.shape[1])
        P = int(prefix_p)
        # chunk budget: smaller dispatches overlap each other and the
        # fetches better than fewer big ones amortize issue cost
        budget = _RESERVE_BUDGET
        # full-result OR, no tombstones: wire-dedup contract (ship sorted
        # stream with duplicates; zero deltas drop host-side) — skips the
        # device compaction sort
        wd = not P and op == "or" and (
            removed is None or removed.shape[0] == 0)
        out_all: List = [None] * len(batches)
        resq: deque = deque()
        clsq: deque = deque()

        # pagination OR with no tombstone filter: windowed compaction
        # (first P*K sorted lanes) skips the second full-row sort
        # (boolean_concat_step's prefix_p contract; the post-filter and
        # AND cases need full compaction)
        win = P if (P and op == "or" and (
            removed is None or removed.shape[0] == 0)) else 0

        # with tables retained, the dictionary probe runs ON HOST
        # (_host_resolve_sb): the class grouping needs the block sums
        # host-side anyway, and the device path's blocking (Q,) sb fetch
        # sits ON the dispatch critical path — every later dispatch queues
        # behind one round trip per batch. Postings decode/sort/page stays
        # on device.
        host_res = st.host_ready()

        def stage_resolve(bi):
            nq, qk, kv = self._batch_pack(st, batches[bi])
            if nq == 0:
                resq.append((bi, 0, None, None, None))
                return
            # cross-query dedup: Zipfian mixes repeat whole queries —
            # serve each distinct (term-set, k) row once through the
            # resolve/classes/harvest pipeline (compute AND wire volume
            # scale with the unique count) and fan out at harvest. The
            # padded unique rows are zero (k=0 -> miss -> count 0).
            nu, qk_u, kv_u, inv = self._dedup_batch(nq, qk, kv)
            if inv is not None:
                nq, qk, kv = nu, qk_u, kv_u
            if host_res:
                idxs, _, sb = _host_resolve_sb(st.tables, qk)
                idx_dev, found_dev = _JIT_SPLIT_IDX(jnp.asarray(idxs))
                resq.append(
                    (bi, nq, inv, (kv, jnp.asarray(kv)),
                     (idx_dev, found_dev, sb))
                )
                return
            # no host tables: resolve + per-query block sum reduced ON
            # DEVICE (the host only ever summed the (Q, K) raw matrix —
            # it reads back the (Q,) sum); idx/found stay device-resident
            # and class chunks select rows via tiny selector uploads
            # (_concat_bool_sel_step)
            r = _JIT_RESOLVE_SB(
                s.keys, s.counts, jnp.asarray(qk), s.hash_slots, s.max_probes
            )
            r[2].copy_to_host_async()
            resq.append((bi, nq, inv, (kv, jnp.asarray(kv)), r))

        def stage_classes(item):
            bi, nq, inv, kvs, r = item
            if nq == 0:
                clsq.append((bi, 0, None, [], {}))
                return
            kv, kv_dev = kvs
            idx_dev, found_dev, sb_dev = r
            sb_q = (sb_dev[:nq] if isinstance(sb_dev, np.ndarray)
                    else np.asarray(sb_dev)[:nq].astype(np.int64))
            order = np.argsort(sb_q, kind="stable").astype(np.int32)
            pos = 0
            dispatches = []
            singles: Dict[int, np.ndarray] = {}
            if P:
                # ONE (QB, P+1) result buffer per batch (values + count
                # column, see _scatter_p_step): every fetched array pays a
                # transfer latency, so every chunk scatters its P-slice
                # into this and the harvest fetches ONE array per batch
                obuf = jnp.zeros((int(idx_dev.shape[0]), P + 1), jnp.uint32)
            for SB in self._SB_CLASSES:
                hi = int(np.searchsorted(sb_q[order], SB, side="right"))
                members = order[pos:hi]
                pos = hi
                if not len(members):
                    continue
                qb = max(8, (budget // (SB * max(stride, 128))) // 8 * 8)
                for c0 in range(0, len(members), qb):
                    batch = members[c0 : c0 + qb]
                    B = 8
                    while B < len(batch):
                        B *= 2
                    sel = np.full(B, -1, dtype=np.int32)
                    sel[: len(batch)] = batch
                    sel_dev = jnp.asarray(sel)
                    o, oc = _JIT_CONCAT_BOOL_SEL(
                        s.blocks, s.term_block_start, s.counts,
                        idx_dev, found_dev, kv_dev, sel_dev,
                        SB, op, prefix_p=win, wire_dedup=wd,
                    )
                    if removed is not None and removed.shape[0] > 0:
                        o, oc = _JIT_FILTER(o, oc, removed)
                    if P:
                        # coalesce into the batch buffers (a per-chunk
                        # P-slice copy pays the per-array fetch latency; a
                        # pack dispatched at harvest time serializes the
                        # pipeline)
                        obuf = _JIT_SCATTER_P(obuf, sel_dev, o, oc)
                        continue
                    # full-result route: masked max delta rides the
                    # counts fetch and picks the wire width at harvest
                    md = _JIT_WIRE_META(o, oc)
                    md.copy_to_host_async()
                    oc.copy_to_host_async()
                    dispatches.append((batch, o, oc, md))
                if pos >= nq:
                    break
            # beyond the largest class (pathological): singly, exact budget
            for qi in order[pos:]:
                SB = int(_round_up(int(sb_q[qi]), 8))
                sel = np.full(8, -1, dtype=np.int32)
                sel[0] = qi
                sel_dev = jnp.asarray(sel)
                o, oc = _JIT_CONCAT_BOOL_SEL(
                    s.blocks, s.term_block_start, s.counts,
                    idx_dev, found_dev, kv_dev, sel_dev,
                    SB, op, prefix_p=win,
                )
                if removed is not None and removed.shape[0] > 0:
                    o, oc = _JIT_FILTER(o, oc, removed)
                if P:
                    obuf = _JIT_SCATTER_P(obuf, sel_dev, o, oc)
                    continue
                c = int(np.asarray(oc)[0])
                # store the TRUE count with the full-result values
                singles[int(qi)] = (c, np.asarray(o[0, :c]).copy())
            if P:
                if os.environ.get("TPI_WIRE", "1") != "0":
                    # u16 delta plane (~1.8x fewer bytes) packed NOW —
                    # static width, so the pack dispatch pipelines with
                    # the next batches; obuf stays resident for the rare
                    # overflow-row escape (see _pack_p_step)
                    pk = _JIT_PACK_P(obuf)
                    pk.copy_to_host_async()
                    clsq.append((bi, nq, inv, (pk, obuf), singles))
                    return
                obuf.copy_to_host_async()
                clsq.append((bi, nq, inv, (obuf, None), singles))
                return
            clsq.append((bi, nq, inv, dispatches, singles))

        def stage_harvest(item):
            bi, nq, inv, dispatches, singles = item
            if nq == 0:
                if columnar:
                    empty = (np.zeros(0, np.uint32), np.zeros(1, np.int64))
                    out_all[bi] = empty + (np.zeros(0, np.int64),) if P else empty
                else:
                    out_all[bi] = []
                return
            if P:
                # pagination harvest: ONE device fetch per batch (the u16
                # delta plane, or the raw (QB, P+1) buffer under
                # TPI_WIRE=0) and a fully vectorized assembly — no
                # per-query Python loop, one per-array fetch latency
                pk_dev, obuf_dev = dispatches
                if obuf_dev is None:  # TPI_WIRE=0: raw u32 buffer
                    o_h = np.asarray(pk_dev)
                    counts = o_h[:nq, P].astype(np.int64)
                    vals = o_h[:nq, :P]
                else:
                    pk = np.asarray(pk_dev)[:nq]
                    d = pk[:, : P - 1].astype(np.uint32)
                    first = pk[:, P - 1].astype(np.uint32) | (
                        pk[:, P].astype(np.uint32) << 16)
                    hi = pk[:, P + 2].astype(np.int64)
                    counts = pk[:, P + 1].astype(np.int64) | (
                        (hi & 0x7FFF) << 16)
                    vals = np.empty((nq, P), np.uint32)
                    vals[:, 0] = first
                    vals[:, 1:] = first[:, None] + np.cumsum(
                        d, axis=1, dtype=np.uint32)
                    ovr = np.nonzero(hi >> 15)[0]
                    if len(ovr):
                        # overflow escape: some kept delta >= 2^16 —
                        # fetch those rows raw from the resident buffer
                        B = 8
                        while B < len(ovr):
                            B *= 2
                        sel = np.zeros(B, dtype=np.int32)
                        sel[: len(ovr)] = ovr
                        raw = np.asarray(_JIT_TAKE_ROWS(
                            obuf_dev, jnp.asarray(sel)))[: len(ovr)]
                        vals[ovr] = raw[:, :P]
                        counts[ovr] = raw[:, P].astype(np.int64)
                if inv is not None:
                    # dedup fan-out: row i of the full batch is unique
                    # group inv[i]'s row (bounded P-slice, so the gather
                    # is ~P*4 B per query — trivial next to the serve)
                    counts = counts[inv]
                    vals = vals[inv]
                    nq = len(inv)
                kept = np.minimum(counts, P)
                pvoffs = np.zeros(nq + 1, dtype=np.int64)
                np.cumsum(kept, out=pvoffs[1:])
                m = np.arange(P, dtype=np.int64)[None, :] < kept[:, None]
                out_all[bi] = (vals[m], pvoffs, counts)
                return
            ocs, mds = (
                jax.device_get(
                    ([d[2] for d in dispatches],
                     [d[3] for d in dispatches])
                ) if dispatches else ([], [])
            )
            outs = self._wire_fetch(dispatches, ocs, mds)
            rows: List[Optional[np.ndarray]] = [None] * nq
            for (batch, _, _, _), oc, o in zip(dispatches, ocs, outs):
                for j, qi in enumerate(batch):
                    row = o[j, : oc[j]]
                    rows[qi] = _dedup_adjacent(row) if wd else row
            for qi, (c, v) in singles.items():
                rows[qi] = v
            if inv is not None:
                # dedup fan-out (full results): duplicates share the
                # unique row here; both output forms below copy per row
                # (_rows_to_columnar packs, np.array copies), so callers
                # never alias
                rows = [rows[int(u)] for u in inv]
            if columnar:
                vals, voffs = _rows_to_columnar(rows)
                out_all[bi] = (vals, voffs)
            else:
                out_all[bi] = [np.array(r, dtype=np.uint32) for r in rows]

        for bi in range(len(batches)):
            stage_resolve(bi)
            if len(resq) > depth:
                stage_classes(resq.popleft())
            if len(clsq) > depth:
                stage_harvest(clsq.popleft())
        while resq:
            stage_classes(resq.popleft())
            if len(clsq) > depth:
                stage_harvest(clsq.popleft())
        while clsq:
            stage_harvest(clsq.popleft())
        return out_all

    @staticmethod
    def _wire_fetch(dispatches, ocs, mds):
        """Trip 2 of a full-result harvest: per dispatch, ship the
        delta-packed plane at the width its masked max delta allows
        (u8/u16 — see the wire codec above _JIT_WIRE_META), or the raw u32
        trim when deltas exceed 16 bits. One device_get covers every
        dispatch. dispatches rows are (query indices, out, oc, maxdelta).
        TPI_WIRE=0 forces the raw trim (operational escape hatch; also the
        A/B lever the codec's win is measured with)."""
        packed = os.environ.get("TPI_WIRE", "1") != "0"
        fetches, wire = [], []
        for (_, o, _, _), oc_h, md_h in zip(dispatches, ocs, mds):
            maxc = int(oc_h.max(initial=0))
            if maxc <= 1:
                fetches.append(o[:, :1])
                wire.append(False)
            elif packed and int(md_h) < (1 << 16):
                f, dd = _JIT_WIRE_PACK(o, bits=8 if int(md_h) < 256 else 16)
                fetches.append((f, dd[:, : maxc - 1]))
                wire.append(True)
            else:
                fetches.append(o[:, :maxc])
                wire.append(False)
        fetched = jax.device_get(fetches)
        return [
            _wire_unpack(*fo) if w else fo for fo, w in zip(fetched, wire)
        ]

    def _boolean_concat(self, st, queries, qk, kv, op: str, removed):
        """Exact AND/OR sized by each query's REAL total postings:
        resolve counts (cheap pass), group queries into total-block classes,
        then one concat-decode + sort + run-length reduction per class
        (ops/concat_bool.py). No padding to the longest list, no re-serve."""
        s = st.snap
        nq = len(queries)
        K = qk.shape[1]
        if st.host_ready():
            # retained tables: probe the dictionary on host — the chunk
            # builder needs idx/found/counts HOST-side anyway, so this
            # removes the one-shot path's full blocking resolve round trip
            # (dispatch + fetch) from in front of every class dispatch
            idxs, cnt, _ = _host_resolve_sb(st.tables, qk)
            idx_h, found_h = np.maximum(idxs, 0), idxs >= 0
            sb_q = np.minimum(
                -(-cnt[:nq] // 128), 1 << 30
            ).sum(axis=1)
        else:
            idx, found, raw = _JIT_RESOLVE(
                s.keys, s.counts, jnp.asarray(qk), s.hash_slots, s.max_probes
            )
            idx_h, found_h, raw_h = jax.device_get((idx, found, raw))
            sb_q = np.minimum(
                -(-raw_h[:nq].astype(np.int64) // 128), 1 << 30
            ).sum(axis=1)
        results: List[Optional[np.ndarray]] = [None] * nq
        order = np.argsort(sb_q, kind="stable")
        stride = int(s.blocks.shape[1])
        pos = 0
        # full-result OR with no tombstone filter: ship the sorted stream
        # WITH cross-list duplicates and drop them host-side during
        # assembly (zero wire deltas) — skips the compaction sort (see
        # boolean_concat_step's wire_dedup contract)
        wd = op == "or" and (removed is None or removed.shape[0] == 0)
        # phase 1: dispatch every class chunk (async); B pads to a power of
        # two so compiled shapes repeat across batches
        dispatches = []  # (query indices, out_dev, oc_dev)
        for SB in self._SB_CLASSES:
            hi = int(np.searchsorted(sb_q[order], SB, side="right"))
            members = order[pos:hi]
            pos = hi
            if not len(members):
                continue
            qb = max(8, (_RESERVE_BUDGET // (SB * max(stride, 128))) // 8 * 8)
            for c0 in range(0, len(members), qb):
                batch = members[c0 : c0 + qb]
                B = 8
                while B < len(batch):
                    B *= 2
                bi = np.zeros((B, K), dtype=np.int32)
                bf = np.zeros((B, K), dtype=bool)
                bkv = np.zeros(B, dtype=np.int32)
                bi[: len(batch)] = idx_h[batch]
                bf[: len(batch)] = found_h[batch]
                bkv[: len(batch)] = kv[batch]
                out, oc = _JIT_CONCAT_BOOL(
                    s.blocks, s.term_block_start, s.counts,
                    jnp.asarray(bi), jnp.asarray(bf), jnp.asarray(bkv),
                    SB, op, wire_dedup=wd,
                )
                if removed is not None and removed.shape[0] > 0:
                    out, oc = _JIT_FILTER(out, oc, removed)
                md = _JIT_WIRE_META(out, oc)
                md.copy_to_host_async()
                oc.copy_to_host_async()
                dispatches.append((batch, out, oc, md))
            if pos >= nq:
                break
        # phase 2: ONE pipelined fetch of all counts + max deltas, then one
        # wire-packed fetch of all result prefixes (each device_get issues
        # every async copy before blocking — sequential np.asarray would pay
        # one transfer latency per array; the delta packing halves/quarters
        # the second, dominant fetch)
        ocs, mds = (
            jax.device_get(
                ([d[2] for d in dispatches], [d[3] for d in dispatches])
            ) if dispatches else ([], [])
        )
        outs = self._wire_fetch(dispatches, ocs, mds)
        for (batch, _, _, _), oc, out in zip(dispatches, ocs, outs):
            for j, qi in enumerate(batch):
                row = out[j, : oc[j]]
                results[qi] = _dedup_adjacent(row).copy() if wd else row.copy()
        # queries beyond the largest class (pathological): process singly at
        # their exact block budget rounded up
        for qi in order[pos:]:
            SB = int(_round_up(int(sb_q[qi]), 8))
            bi = np.repeat(idx_h[qi : qi + 1], 8, axis=0).astype(np.int32)
            bf = np.repeat(found_h[qi : qi + 1], 8, axis=0)
            bkv = np.full(8, kv[qi], dtype=np.int32)
            out, oc = _JIT_CONCAT_BOOL(
                s.blocks, s.term_block_start, s.counts,
                jnp.asarray(bi), jnp.asarray(bf), jnp.asarray(bkv), SB, op,
            )
            if removed is not None and removed.shape[0] > 0:
                out, oc = _JIT_FILTER(out, oc, removed)
            oc = np.asarray(oc)
            results[qi] = np.asarray(out[0, : oc[0]]).copy()
        return results

