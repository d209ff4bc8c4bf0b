"""Stable left-compaction of masked rows.

Every set-op formulation ends with "keep these lanes, drop the rest,
pack survivors to the left in order". Three device formulations, all
bit-identical (tests/test_ops.py):

* SORT (default): `sort(where(keep, vals, SENTINEL), axis=1)` — a full
  sort of the row; valid because every call site's kept lanes ascend.
* GATHER (compact_keep): cumsum of the keep mask + a branchless batched
  binary search for each output rank — ~2*log2(S) (Q, S) lane gathers.
* SHIFT (compact_shift): cumsum + log2(S) monotone static lane shifts,
  no gathers, no sort.

On one H100 80GB HBM3 (400 W power limit), u32 rows, 30% kept: at
(2048, 4096) sort 0.781 ms, gather 0.777 ms, shift 0.855 ms (medians of
20); at (2048, 16384) sort 1.438 ms, gather 1.923 ms, shift 3.174 ms
(experiments/gpu_and_profile.py). Sort ties gather at the smaller shape
and wins at the larger, so it stays the default; TPI_COMPACT=gather keeps
the A/B one environment variable away.
"""
from __future__ import annotations

import os as _os

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

# "sort" is the faster formulation on the GPU (module docstring); the knob
# keeps the A/B one env var away
USE_GATHER = _os.environ.get("TPI_COMPACT", "sort") == "gather"


def compact_rows(vals: jnp.ndarray, keep: jnp.ndarray, fill=SENTINEL):
    """Compacted rows only — SENTINEL-masked sort semantics.

    Equals `jnp.sort(jnp.where(keep, vals, SENTINEL), axis=1)` whenever
    the kept lanes of each row ascend (every set-op call site: keep
    masks a row-sorted array). Callers keep computing their own counts
    (several adjust them, e.g. the genuine-0xFFFFFFFF member).
    """
    if not USE_GATHER:
        return jnp.sort(
            jnp.where(keep, vals, jnp.asarray(fill, vals.dtype)), axis=1
        )
    return compact_keep(vals, keep, fill)[0]


def compact_shift(vals: jnp.ndarray, keep: jnp.ndarray, fill=SENTINEL):
    """Gather-free stable left-compaction via monotone rank shifts.

    Each kept lane must move LEFT by d(j) = #dropped lanes before j — a
    non-decreasing function of j. Decompose d in binary and apply the
    shifts bit-by-bit LOW to HIGH: after bits 0..b-1 are applied, a kept
    lane sits at dest + (d & ~(2^b - 1)); since dest is strictly
    increasing and d is non-decreasing along the row, those positions
    stay strictly increasing at every step, so no two lanes ever collide
    (high-to-low order does NOT have this property: keep=[0,1,0,1] puts
    lane 3 on top of lane 1 at the s=2 step). Each step is a static
    lane shift + two selects — no gathers, no sort: O(log S) elementwise
    passes vs the sort network's O(log^2 S) compare-exchange stages.

    Unlike compact_rows this does NOT require vals' kept lanes to ascend
    — it is order-preserving for any input (same contract as
    compact_keep). Returns (out, oc) like compact_keep.
    """
    Q, S = vals.shape
    f = jnp.asarray(fill, vals.dtype)
    pos = jnp.cumsum(keep.astype(jnp.int32), axis=1)      # 1-based rank
    oc = pos[:, -1]
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, S), 1)
    # remaining left-shift per lane; dropped lanes carry 0 (never move,
    # hold `fill`, and may be overwritten by arriving kept lanes)
    d = jnp.where(keep, lane - (pos - 1), 0)
    x = jnp.where(keep, vals, f)
    for b in range((S - 1).bit_length()):
        s = 1 << b
        xin = jnp.concatenate([x[:, s:], jnp.full((Q, s), f, x.dtype)], axis=1)
        din = jnp.concatenate([d[:, s:], jnp.zeros((Q, s), d.dtype)], axis=1)
        take = (din & s) != 0
        gone = (d & s) != 0
        x = jnp.where(take, xin, jnp.where(gone, f, x))
        d = jnp.where(take, din - s, jnp.where(gone, 0, d))
    return x, oc.astype(jnp.int32)


def compact_keep(vals: jnp.ndarray, keep: jnp.ndarray, fill=SENTINEL):
    """Pack kept lanes of each row to the left, preserving order.

    vals: (Q, S); keep: (Q, S) bool. Returns (out (Q, S), oc (Q,) i32)
    where out[:, :oc] are the kept values in their original relative
    order and out[:, oc:] == fill. No ordering requirement on vals —
    stability alone makes sorted inputs stay sorted. See module
    docstring: correct everywhere, not the default path.
    """
    Q, S = vals.shape
    pos = jnp.cumsum(keep.astype(jnp.int32), axis=1)      # (Q, S) 1-based
    oc = pos[:, -1]
    # iota / zeros_like rather than jnp.arange/jnp.zeros: with static args
    # those build CONCRETE arrays at trace time, which become closed-over
    # jaxpr constants — same C++-fast-path hazard as the SENTINEL note.
    t = jax.lax.broadcasted_iota(jnp.int32, (1, S), 1) + 1  # target ranks
    lo = jnp.zeros_like(pos)
    # branchless first-index-with-pos>=t: lo accumulates the count of
    # prefix entries whose pos < t
    sbit = 1 << max(0, (S - 1).bit_length() - 1)
    while sbit:
        nxt = lo + sbit
        probe = jnp.take_along_axis(
            pos, jnp.minimum(nxt - 1, S - 1), axis=1
        )
        ok = (nxt <= S) & (probe < t)
        lo = jnp.where(ok, nxt, lo)
        sbit >>= 1
    idx = jnp.minimum(lo, S - 1)
    out = jnp.where(
        t <= oc[:, None],
        jnp.take_along_axis(vals, idx, axis=1),
        jnp.asarray(fill, dtype=vals.dtype),
    )
    return out, oc.astype(jnp.int32)
