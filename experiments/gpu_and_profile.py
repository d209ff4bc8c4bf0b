"""Where staged AND spends its device time, and which compaction is faster.

    python experiments/gpu_and_profile.py [--terms 200000] [--out DIR]

Needs a GPU (refuses otherwise). Two measurements, written to DIR
(default chiprun_out/profile) and summarized on stdout:

1. A jax.profiler trace of the staged AND stream at the config-3 shape
   (bench.gen_corpus(terms, mean posting length 1000), 2-8 terms per
   query, 8192-query batches, no retained host tables so every op runs on
   the device). The device events are split by the named scopes of
   ops/concat_bool.boolean_concat_step (concat_decode: layout + gather +
   decode; concat_sort: jnp.sort; concat_compact: run-length marking +
   compaction), by transfers (memcpy), and the rest; with the device's busy
   share of the traced window. The sort's memory roofline is the bytes it
   must read and write once, over the card's 3.35 TB/s.
2. ops/compaction's three left-compaction formulations (sort, gather,
   shift) timed at (2048, 4096) and (2048, 16384), outputs checked equal.
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet (at its 700 W limit)

def reduce_trace(path: str, plane_prefix: str = "/device:GPU") -> dict:
    """Device time per jitted program (hlo_module) and for transfers, and
    the device's busy share of the window, from one .xplane.pb."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    per_module = collections.Counter()
    per_kernel = collections.Counter()
    intervals = []
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                st = dict(ev.stats)
                if "hlo_module" in st:
                    key = str(st["hlo_module"])
                elif "memcpy" in ev.name.lower():
                    key = "transfer"
                else:
                    continue
                per_module[key] += ev.duration_ns
                per_kernel[(key, ev.name)] += ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    intervals.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (intervals[-1][1] - intervals[0][0]) if intervals else 0.0
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:25]
    return {
        "per_program_ms": {k: v / 1e6 for k, v in per_module.most_common()},
        "device_busy_ms": busy / 1e6,
        "device_window_ms": window / 1e6,
        "top_kernels": [{"program": m, "kernel": n, "ms": v / 1e6}
                        for (m, n), v in top],
    }


def _stage_programs():
    """boolean_concat_step split at its named scopes into three jitted
    programs over the same inputs as steps._concat_bool_sel_step."""
    import functools

    import jax
    import jax.numpy as jnp

    from inverted_index_2_tpu.ops import concat_bool as cb

    @functools.partial(jax.jit, static_argnames=("SB",))
    def decode(blocks, tbs, counts, idx_full, found_full, kv_full, sel, SB):
        valid = sel >= 0
        s2 = jnp.maximum(sel, 0)
        idx = idx_full[s2]
        found = found_full[s2] & valid[:, None]
        kv = jnp.where(valid, kv_full[s2], 0)
        K = idx.shape[1]
        kmask = jnp.arange(K, dtype=jnp.int32)[None, :] < kv[:, None]
        live = found & kmask
        cnt = jnp.where(live, counts[idx], 0)
        rows, in_use, bit, cnt_j, cum = cb.concat_layout(tbs[idx], cnt, SB)
        flat, vals, mask = cb.decode_masked(blocks, rows, in_use, bit, cnt_j)
        return flat, (vals, mask, cnt, cum, live, kmask, found, kv)

    sort = jax.jit(lambda flat: jnp.sort(flat, axis=1))

    @functools.partial(jax.jit, static_argnames=("op",))
    def compact(svals, rest, op):
        return cb._reduce_runs(svals, *rest, op, "auto", 0, False)

    return decode, sort, compact


def stage_split(calls, reps: int = 3) -> dict:
    """Device time of each stage over the recorded dispatches of one
    stream (every dispatch of a stage queued back to back, one fence)."""
    import jax

    decode, sort, compact = _stage_programs()
    # recorded as _JIT_CONCAT_BOOL_SEL(blocks, tbs, counts, idx, found, kv,
    # sel, SB, op, ...)
    args_dec = [(a[:7], a[7]) for a, kw in calls]
    flats = [decode(*a, SB=sb) for a, sb in args_dec]
    sorted_ = [sort(f[0]) for f in flats]
    for (a, kw), sv, f in zip(calls, sorted_, flats):
        compact(sv, f[1], op=a[8])
    jax.block_until_ready((flats, sorted_))

    def timed(run):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(run())
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[reps // 2] * 1e3

    return {
        "decode_ms": timed(lambda: [decode(*a, SB=sb) for a, sb in args_dec]),
        "sort_ms": timed(lambda: [sort(f[0]) for f in flats]),
        "compact_ms": timed(lambda: [
            compact(sv, f[1], op=a[8])
            for (a, kw), sv, f in zip(calls, sorted_, flats)]),
        "dispatches": len(calls),
    }


def profile_and(terms: int, out_dir: str, nb: int = 3, Q: int = 8192) -> dict:
    import jax

    import bench
    import chip_smoke as cs
    from inverted_index_2_tpu.models import staged as staged_mod
    from inverted_index_2_tpu.models.query_engine import (
        QueryEngine, build_host_tables, upload_tables)

    blob, offsets, values, voffs = bench.gen_corpus(terms, 1000, seed=11)
    ref = cs.Lists.from_corpus(blob, offsets, values, voffs)
    snap = upload_tables(build_host_tables(blob, offsets, values, voffs))
    eng = QueryEngine(snap, L=2048, q_bucket=Q)
    stream = cs.query_stream(len(ref), nb, Q, seed=11)
    tstream = [cs.to_terms(ref, b) for b in stream]

    def run():
        return eng.boolean_staged(tstream, "and", columnar=True)

    for _ in range(2):
        run()
    walls = []
    for _ in range(5):
        t0 = time.monotonic()
        got = run()
        walls.append(time.monotonic() - t0)
    for b, g in zip(stream, got):
        cs.check_columnar("profile and", g, [ref.expect(q, "and") for q in b])

    # the class-chunk dispatches of one stream, for the per-stage split
    calls = []
    orig = staged_mod._JIT_CONCAT_BOOL_SEL
    staged_mod._JIT_CONCAT_BOOL_SEL = (
        lambda *a, **kw: calls.append((a, kw)) or orig(*a, **kw))
    try:
        run()
    finally:
        staged_mod._JIT_CONCAT_BOOL_SEL = orig
    stages = stage_split(calls)

    tdir = os.path.join(out_dir, "trace")
    with jax.profiler.trace(tdir):
        t0 = time.monotonic()
        run()
        traced_wall = time.monotonic() - t0
    path = sorted(glob.glob(os.path.join(tdir, "plugins/profile/*/*.xplane.pb")))[-1]
    red = reduce_trace(path)
    # sort roofline: every (B, SB*128) u32 row the stream sorted, read and
    # written once
    sort_bytes = float(sum(int(a[6].shape[0]) * a[7] * 128 * 4 * 2
                           for a, kw in calls))
    red.update({
        "queries": nb * Q,
        "wall_s_median_of_5": sorted(walls)[2],
        "wall_s_all": walls,
        "traced_wall_s": traced_wall,
        "stages": stages,
        "sort_bytes_read_written_once": sort_bytes,
        "sort_memory_bound_ms": sort_bytes / HBM_BYTES_PER_S * 1e3,
        "sort_roofline_share": (sort_bytes / HBM_BYTES_PER_S * 1e3
                                / stages["sort_ms"]),
        "trace_file": os.path.relpath(path, HERE),
    })
    return red


def time_compaction(reps: int = 20) -> dict:
    import jax
    import jax.numpy as jnp

    from inverted_index_2_tpu.ops import compaction as C

    fns = {
        "sort": jax.jit(lambda v, k: jnp.sort(jnp.where(k, v, C.SENTINEL), axis=1)),
        "gather": jax.jit(lambda v, k: C.compact_keep(v, k)[0]),
        "shift": jax.jit(lambda v, k: C.compact_shift(v, k)[0]),
    }
    out = {}
    rng = np.random.default_rng(3)
    for Q, S in ((2048, 4096), (2048, 16384)):
        v = np.sort(rng.integers(0, 2**31, size=(Q, S), dtype=np.uint32), axis=1)
        k = rng.random((Q, S)) < 0.3
        vd, kd = jax.device_put(v), jax.device_put(k)
        res = {}
        ref = None
        for name, f in fns.items():
            r = f(vd, kd).block_until_ready()
            if ref is None:
                ref = np.asarray(r)
            elif not np.array_equal(np.asarray(r), ref):
                raise AssertionError(f"compaction {name} differs at {(Q, S)}")
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                f(vd, kd).block_until_ready()
                ts.append(time.perf_counter() - t0)
            res[name] = {"median_ms": sorted(ts)[reps // 2] * 1e3,
                         "min_ms": min(ts) * 1e3}
        out[f"{Q}x{S}"] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--terms", type=int, default=200_000)
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out", "profile"))
    args = ap.parse_args(argv)

    import jax

    from inverted_index_2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU, found {dev.platform}", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    os.makedirs(args.out, exist_ok=True)
    result = {"card": card, "device_kind": dev.device_kind,
              "compaction": time_compaction(),
              "staged_and": profile_and(args.terms, args.out)}
    with open(os.path.join(args.out, "profile.json"), "w") as f:
        json.dump(result, f, indent=1)
    sa = result["staged_and"]
    print(f"card: {card}")
    print("compaction:", json.dumps(result["compaction"]))
    print(f"staged AND: {sa['queries']} queries, wall median "
          f"{sa['wall_s_median_of_5']:.4f} s (all {sa['wall_s_all']})")
    print(f"traced window: device busy {sa['device_busy_ms']:.2f} ms of "
          f"{sa['device_window_ms']:.2f} ms, traced wall {sa['traced_wall_s']:.4f} s")
    print("device ms per program:", json.dumps(sa["per_program_ms"]))
    print("stage split (ms):", json.dumps(sa["stages"]))
    print(f"sort: {sa['sort_bytes_read_written_once'] / 1e9:.3f} GB read+written "
          f"once, memory bound {sa['sort_memory_bound_ms']:.3f} ms, share "
          f"{sa['sort_roofline_share']:.4f}")
    for k in sa["top_kernels"][:15]:
        print(f"  {k['ms']:9.3f} ms {k['program'][:30]:30s} {k['kernel'][:50]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
