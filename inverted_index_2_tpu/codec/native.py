"""ctypes loader for the native C++ host codec (native/codec.cpp).

The native library implements the exact wire layout of packing.py; this
module exposes drop-in bulk encode/decode that packing.py dispatches to when
the shared object is present (built via `make -C native`, and rebuilt on
first use whenever it is missing or older than its sources, when a compiler
is available). Falls back silently to the numpy
implementations otherwise — results are bit-identical either way (asserted by
tests/test_native.py).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

# native dir: env override > repo-checkout layout (three levels up). When the
# package is installed outside the checkout and the lib is absent, we fall
# back to numpy with one diagnostic log line (silent fallback would hide a
# large perf regression).
_here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.environ.get("TPI_NATIVE_DIR", os.path.join(_here, "native"))
_SO_PATH = os.path.join(_NATIVE_DIR, "libtpicodec.so")

_lib = None
_lib_lock = threading.Lock()
_tried = False

_SOURCES = ("codec.cpp", "Makefile")


def _stale(native_dir: str) -> bool:
    """The library is missing or older than a source it is built from."""
    so = os.path.join(native_dir, os.path.basename(_SO_PATH))
    if not os.path.exists(so):
        return True
    built = os.path.getmtime(so)
    return any(
        os.path.getmtime(p) > built
        for p in (os.path.join(native_dir, f) for f in _SOURCES)
        if os.path.exists(p)
    )


def _ensure_built(native_dir: str) -> bool:
    """Run `make` in `native_dir` when the library is stale (it is built
    with -march=native, so a library built on another CPU, or from older
    sources, must not be loaded as it is). Returns False if a needed build
    failed."""
    if not (os.path.exists(os.path.join(native_dir, "Makefile"))
            and _stale(native_dir)):
        return True
    try:
        subprocess.run(
            ["make", "-C", native_dir, "-s"],
            check=True,
            capture_output=True,
            timeout=300,
        )
    except (OSError, subprocess.SubprocessError):
        return False
    return True


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lib_lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("TPI_DISABLE_NATIVE"):
            return None
        if not _ensure_built(_NATIVE_DIR):
            return None
        if not os.path.exists(_SO_PATH):
            import logging

            logging.getLogger("inverted_index_2_tpu").info(
                "native codec not found at %s; using numpy fallbacks "
                "(set TPI_NATIVE_DIR or build native/)", _SO_PATH,
            )
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None
        return _bind(lib)


def _bind(lib):
    global _lib
    try:
        u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")

        lib.tpi_encode_bulk_size.restype = ctypes.c_int64
        lib.tpi_encode_bulk_size.argtypes = [u32p, i64p, ctypes.c_int64, i64p, ctypes.c_int32]
        lib.tpi_encode_bulk_fill.restype = None
        lib.tpi_encode_bulk_fill.argtypes = [u32p, i64p, ctypes.c_int64, i64p, u32p, ctypes.c_int32]
        # _v2 suffix: bounds-checked signature; a stale .so lacking it falls
        # back to numpy via the AttributeError below instead of miscalling.
        lib.tpi_decode_counts_v2.restype = ctypes.c_int32
        lib.tpi_decode_counts_v2.argtypes = [u32p, ctypes.c_int64, i64p, ctypes.c_int64, i64p]
        lib.tpi_decode_bulk.restype = ctypes.c_int32
        lib.tpi_decode_bulk.argtypes = [u32p, ctypes.c_int64, i64p, ctypes.c_int64, u32p, i64p]
        lib.tpi_scan_blocks.restype = ctypes.c_int32
        lib.tpi_scan_blocks.argtypes = [u32p, ctypes.c_int64, i64p, ctypes.c_int64, i64p, i32p]
        lib.tpi_hash_build.restype = None
        lib.tpi_hash_build.argtypes = [u32p, ctypes.c_int64, i32p, ctypes.c_int64]
        lib.tpi_hash_build_v2.restype = ctypes.c_int32
        lib.tpi_hash_build_v2.argtypes = [u32p, ctypes.c_int64, i32p, ctypes.c_int64]
        lib.tpi_hash_probe.restype = None
        lib.tpi_hash_probe.argtypes = [
            u32p, ctypes.c_int64, i32p, ctypes.c_int64, ctypes.c_int32,
            u32p, ctypes.c_int64, i32p,
        ]
        u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
        u16p = np.ctypeslib.ndpointer(dtype=np.uint16, flags="C_CONTIGUOUS")
        lib.tpi_ingest_sort.restype = ctypes.c_int64
        lib.tpi_ingest_sort.argtypes = [u8p, i64p, ctypes.c_int64, i32p, u16p]
        lib.tpi_ingest_sort_concat.restype = ctypes.c_int64
        lib.tpi_ingest_sort_concat.argtypes = [u8p, i64p, ctypes.c_int64, u16p, u8p, i64p]
        lib.tpi_concat_terms.restype = None
        lib.tpi_concat_terms.argtypes = [u8p, i64p, i32p, ctypes.c_int64, u8p, i64p]
        lib.tpi_merge_gather.restype = ctypes.c_int64
        lib.tpi_merge_gather.argtypes = [u32p, i64p, i64p, i64p, ctypes.c_int64, u32p, i64p]
        lib.tpi_merge_pairs.restype = ctypes.c_int64
        lib.tpi_merge_pairs.argtypes = [u32p, i64p, ctypes.c_int64, u32p, ctypes.c_int64, u32p, i64p]
        lib.tpi_gather_bytes.restype = None
        lib.tpi_gather_bytes.argtypes = [u8p, i64p, i64p, ctypes.c_int64, u8p]
        lib.tpi_sort_key_rows.restype = None
        lib.tpi_sort_key_rows.argtypes = [u32p, ctypes.c_int64, ctypes.c_int64, i32p]
        lib.tpi_pack_keys.restype = None
        lib.tpi_pack_keys.argtypes = [u8p, i64p, ctypes.c_int64, ctypes.c_int64, u32p]
        lib.tpi_boolean_host.restype = ctypes.c_int64
        lib.tpi_boolean_host.argtypes = [
            u32p, i64p, u8p, u32p, i64p, u8p, ctypes.c_int32,
            i64p, ctypes.c_int64, u32p, ctypes.c_int64, ctypes.c_int32,
            u32p, i64p,
        ]
        lib.tpi_boolean_serve.restype = ctypes.c_int64
        lib.tpi_boolean_serve.argtypes = [
            u32p, ctypes.c_int64, i64p, u32p, ctypes.c_int64, i64p,
            ctypes.c_int32, i64p, ctypes.c_int64, u32p, ctypes.c_int64,
            ctypes.c_int32, u32p, i64p,
        ]
        lib.tpi_fanout_u32.restype = None
        lib.tpi_fanout_u32.argtypes = [
            u32p, i64p, i64p, ctypes.c_int64, i64p, u32p,
        ]
    except AttributeError:
        # stale shared object (symbol set changed): fall back to numpy
        return None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def encode_bulk(values: np.ndarray, value_offsets: np.ndarray, byte_align: int = 0):
    """Native bulk encode; layout-identical to packing.encode_bulk (numpy)."""
    lib = _load()
    assert lib is not None
    values = np.ascontiguousarray(values, dtype=np.uint32)
    voffs = np.ascontiguousarray(value_offsets, dtype=np.int64)
    T = len(voffs) - 1
    outs = np.zeros(max(T, 1), dtype=np.int64)
    if T == 0:
        return np.zeros(0, dtype=np.uint32), outs[:0]
    total = lib.tpi_encode_bulk_size(values, voffs, T, outs, int(byte_align))
    if total < 0:
        raise ValueError("encode requires strictly increasing values per list")
    words = np.zeros(total, dtype=np.uint32)
    lib.tpi_encode_bulk_fill(values, voffs, T, outs, words, int(byte_align))
    return words, outs


def decode_bulk(words: np.ndarray, outs: np.ndarray):
    """Native bulk decode; mirrors packing.decode_bulk (numpy)."""
    lib = _load()
    assert lib is not None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    outs = np.ascontiguousarray(outs, dtype=np.int64)
    T = len(outs)
    counts = np.zeros(max(T, 1), dtype=np.int64)
    if T == 0:
        return np.zeros(0, np.uint32), counts[:0], np.zeros(1, np.int64)
    if lib.tpi_decode_counts_v2(words, len(words), outs, T, counts) != 0:
        raise ValueError("native decode: out-of-range posting offset or count")
    counts = counts[:T]
    voffs = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(counts, out=voffs[1:])
    values = np.zeros(int(voffs[-1]), dtype=np.uint32)
    rc = lib.tpi_decode_bulk(words, len(words), outs, T, values, voffs)
    if rc != 0:
        raise ValueError("native decode: malformed posting block")
    return values, counts, voffs


def ingest_sort(blob: np.ndarray, offsets: np.ndarray):
    """Sort terms by (shard key, bytes) and dedupe (see codec.cpp).

    Returns (order int32 (m,), shard_of uint16 (m,)).
    """
    lib = _load()
    assert lib is not None
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    order = np.zeros(max(n, 1), dtype=np.int32)
    shard_of = np.zeros(max(n, 1), dtype=np.uint16)
    if n == 0:
        return order[:0], shard_of[:0]
    m = lib.tpi_ingest_sort(blob, offsets, n, order, shard_of)
    return order[:m], shard_of[:m]


def ingest_sort_concat(blob: np.ndarray, offsets: np.ndarray):
    """Fused sort+dedupe+gather (ingest hot path — see codec.cpp).

    Returns (shard_of uint16 (m,), out_blob uint8, out_offsets int64 (m+1,)).
    """
    lib = _load()
    assert lib is not None
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    if n == 0:
        return (
            np.zeros(0, dtype=np.uint16),
            np.zeros(0, dtype=np.uint8),
            np.zeros(1, dtype=np.int64),
        )
    shard_of = np.zeros(n, dtype=np.uint16)
    out_blob = np.empty(int(offsets[-1]), dtype=np.uint8)
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    m = lib.tpi_ingest_sort_concat(blob, offsets, n, shard_of, out_blob, out_offsets)
    return shard_of[:m], out_blob[: int(out_offsets[m])], out_offsets[: m + 1]


def concat_terms(blob: np.ndarray, offsets: np.ndarray, order: np.ndarray):
    """Gather terms in `order` into a fresh (blob, offsets) pair."""
    lib = _load()
    assert lib is not None
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    order = np.ascontiguousarray(order, dtype=np.int32)
    m = len(order)
    lens = offsets[order + 1] - offsets[order]
    out_blob = np.zeros(int(lens.sum()), dtype=np.uint8)
    out_offsets = np.zeros(m + 1, dtype=np.int64)
    if m:
        lib.tpi_concat_terms(blob, offsets, order, m, out_blob, out_offsets)
    return out_blob, out_offsets


def pack_keys(blob: np.ndarray, offsets: np.ndarray, W: int) -> np.ndarray:
    """Native twin of keys.pack_blob: (n, W+1) big-endian key rows."""
    lib = _load()
    assert lib is not None
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    out = np.empty((max(n, 1), W + 1), dtype=np.uint32)
    if n:
        lib.tpi_pack_keys(blob, offsets, n, W, out)
    return out[:n]


def sort_key_rows(keys: np.ndarray) -> np.ndarray:
    """Stable lexicographic argsort of (N, Wp1) uint32 key rows (LSD radix)."""
    lib = _load()
    assert lib is not None
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    n = keys.shape[0]
    order = np.zeros(max(n, 1), dtype=np.int32)
    if n:
        lib.tpi_sort_key_rows(keys, n, keys.shape[1], order)
    return order[:n]


def merge_gather(
    src: np.ndarray,
    starts: np.ndarray,
    counts: np.ndarray,
    group: np.ndarray,
    out_vals: np.ndarray = None,
    out_groups: np.ndarray = None,
):
    """Single-pass ragged gather of values + group tags (merge hot path).

    Callers may pass pre-allocated `out_vals`/`out_groups` (>= total) to
    reuse staging buffers across merges (the compaction scratch pool in
    shard.py); the returned arrays are views of them, valid until the next
    reuse."""
    lib = _load()
    assert lib is not None
    src = np.ascontiguousarray(src, dtype=np.uint32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    group = np.ascontiguousarray(group, dtype=np.int64)
    total = int(counts.sum())
    if out_vals is None or len(out_vals) < total:
        out_vals = np.empty(total, dtype=np.uint32)
    if out_groups is None or len(out_groups) < total:
        out_groups = np.empty(total, dtype=np.int64)
    if len(starts):
        lib.tpi_merge_gather(src, starts, counts, group, len(starts), out_vals, out_groups)
    return out_vals[:total], out_groups[:total]


def merge_pairs(vals: np.ndarray, groups: np.ndarray, removed: np.ndarray):
    """Sort (group,value) pairs, dedupe, drop tombstoned values (merge core).

    Returns (out_vals uint32, out_groups int64), kept prefix only."""
    lib = _load()
    assert lib is not None
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    groups = np.ascontiguousarray(groups, dtype=np.int64)
    removed = np.ascontiguousarray(removed, dtype=np.uint32)
    V = len(vals)
    out_vals = np.zeros(max(V, 1), dtype=np.uint32)
    out_groups = np.zeros(max(V, 1), dtype=np.int64)
    if V == 0:
        return out_vals[:0], out_groups[:0]
    m = lib.tpi_merge_pairs(vals, groups, V, removed, len(removed), out_vals, out_groups)
    return out_vals[:m], out_groups[:m]


def boolean_host(
    v1: np.ndarray, o1: np.ndarray, f1: np.ndarray,
    v2, o2, f2,
    koffs: np.ndarray, removed, is_or: bool,
):
    """Batched AND/OR over two columnar posting tiers (see codec.cpp
    tpi_boolean_host — the host serving route's set-op core). Tier 2 may be
    None (no delta window). Returns (out_vals uint32, out_offs int64 (Q+1,)),
    the kept prefix only; results are fresh memory, never views of the
    inputs."""
    lib = _load()
    assert lib is not None
    v1 = np.ascontiguousarray(v1, dtype=np.uint32)
    o1 = np.ascontiguousarray(o1, dtype=np.int64)
    f1 = np.ascontiguousarray(f1, dtype=np.uint8)
    koffs = np.ascontiguousarray(koffs, dtype=np.int64)
    dual = 1 if v2 is not None else 0
    if dual:
        v2 = np.ascontiguousarray(v2, dtype=np.uint32)
        o2 = np.ascontiguousarray(o2, dtype=np.int64)
        f2 = np.ascontiguousarray(f2, dtype=np.uint8)
    else:
        v2 = np.zeros(0, dtype=np.uint32)
        o2 = np.zeros(len(o1), dtype=np.int64)
        f2 = np.zeros(len(f1), dtype=np.uint8)
    if removed is None:
        removed = np.zeros(0, dtype=np.uint32)
    removed = np.ascontiguousarray(removed, dtype=np.uint32)
    Q = len(koffs) - 1
    total = len(v1) + len(v2)
    out_vals = np.empty(max(total, 1), dtype=np.uint32)
    out_offs = np.zeros(Q + 1, dtype=np.int64)
    if Q:
        n = lib.tpi_boolean_host(
            v1, o1, f1, v2, o2, f2, dual, koffs, Q,
            removed, len(removed), 1 if is_or else 0, out_vals, out_offs,
        )
        out_vals = out_vals[:n]
    else:
        out_vals = out_vals[:0]
    return out_vals, out_offs


def boolean_serve(
    w1: np.ndarray, s1: np.ndarray, w2, s2,
    koffs: np.ndarray, removed, is_or: bool,
):
    """Fused batched AND/OR directly from the compressed posting streams
    (see codec.cpp tpi_boolean_serve): decode + set op + tombstone filter in
    one pass per query. s1/s2 are per-flat-term count-word offsets (-1 =
    miss in that tier); tier 2 (w2, s2) may be None. Returns
    (out_vals uint32, out_offs int64 (Q+1,)) — fresh memory."""
    lib = _load()
    assert lib is not None
    w1 = np.ascontiguousarray(w1, dtype=np.uint32)
    s1 = np.ascontiguousarray(s1, dtype=np.int64)
    koffs = np.ascontiguousarray(koffs, dtype=np.int64)
    dual = 1 if w2 is not None else 0
    if dual:
        w2 = np.ascontiguousarray(w2, dtype=np.uint32)
        s2 = np.ascontiguousarray(s2, dtype=np.int64)
    else:
        w2 = np.zeros(0, dtype=np.uint32)
        s2 = np.full(len(s1), -1, dtype=np.int64)
    if removed is None:
        removed = np.zeros(0, dtype=np.uint32)
    removed = np.ascontiguousarray(removed, dtype=np.uint32)
    Q = len(koffs) - 1
    # out bound = the referenced lists' total count (results only shrink);
    # count words sit at the start offsets
    total = 0
    if len(s1) and len(w1):
        total += int(w1[np.maximum(s1, 0)][s1 >= 0].astype(np.int64).sum())
    if dual and len(s2) and len(w2):
        total += int(w2[np.maximum(s2, 0)][s2 >= 0].astype(np.int64).sum())
    out_vals = np.empty(max(total, 1), dtype=np.uint32)
    out_offs = np.zeros(Q + 1, dtype=np.int64)
    if Q:
        n = lib.tpi_boolean_serve(
            w1, len(w1), s1, w2, len(w2), s2, dual, koffs, Q,
            removed, len(removed), 1 if is_or else 0, out_vals, out_offs,
        )
        if n < 0:
            raise ValueError("native serve: malformed posting block")
        out_vals = out_vals[:n]
    else:
        out_vals = out_vals[:0]
    return out_vals, out_offs


def gather_bytes(src: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Single-pass ragged byte gather (merge blob rebuild)."""
    lib = _load()
    assert lib is not None
    src = np.ascontiguousarray(src, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    out = np.zeros(int(lens.sum()), dtype=np.uint8)
    if len(starts):
        lib.tpi_gather_bytes(src, starts, lens, len(starts), out)
    return out


def hash_probe(keys: np.ndarray, slots: np.ndarray, max_probes: int,
               qkeys: np.ndarray) -> np.ndarray:
    """Native batched exact probe (codec.cpp tpi_hash_probe): query key
    rows -> term indexes (int32, -1 = absent). Same walk + full-key verify
    as hashing.probe_rows_np."""
    lib = _load()
    assert lib is not None
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    qkeys = np.ascontiguousarray(qkeys, dtype=np.uint32)
    slots = np.ascontiguousarray(slots, dtype=np.int32)
    # tpi_hash_probe uses keys.shape[1] as the row stride for BOTH key
    # matrices; a width mismatch would read out-of-stride garbage silently
    # (the numpy fallback raises instead). Guard it here.
    assert qkeys.shape[1] == keys.shape[1], (
        f"hash_probe width mismatch: qkeys {qkeys.shape[1]} vs keys "
        f"{keys.shape[1]}")
    assert len(slots) & (len(slots) - 1) == 0, (
        "hash_probe: slot table size must be a power of two")
    out = np.empty(qkeys.shape[0], dtype=np.int32)
    if qkeys.shape[0]:
        lib.tpi_hash_probe(
            keys, keys.shape[1], slots, len(slots), int(max_probes),
            qkeys, qkeys.shape[0], out,
        )
    return out


def fanout_u32(uvals: np.ndarray, uvoffs: np.ndarray, gid: np.ndarray,
               out: np.ndarray, voffs: np.ndarray) -> None:
    """Dedup fan-out (codec.cpp tpi_fanout_u32): out row i = unique group
    gid[i]'s row — one memcpy per output row, the duplicate-query cost
    floor. voffs MUST be the exact cumsum of uvoffs-diff mapped by gid
    (the caller computes it; out is sized voffs[-1])."""
    lib = _load()
    assert lib is not None
    assert len(voffs) == len(gid) + 1 and len(out) == int(voffs[-1])
    if len(gid):
        lib.tpi_fanout_u32(
            np.ascontiguousarray(uvals, dtype=np.uint32),
            np.ascontiguousarray(uvoffs, dtype=np.int64),
            np.ascontiguousarray(gid, dtype=np.int64),
            len(gid),
            np.ascontiguousarray(voffs, dtype=np.int64),
            out,
        )


def hash_build(hashes: np.ndarray) -> np.ndarray:
    """Native linear-probe hash-table build (see codec/hashing.py)."""
    return hash_build_with_probes(hashes)[0]


def hash_build_with_probes(hashes: np.ndarray, S: int = None):
    """Native build + longest probe chain: (slots, max_probes). `S` forces a
    table size (the mesh stacker shares one size across devices)."""
    lib = _load()
    assert lib is not None
    hashes = np.ascontiguousarray(hashes, dtype=np.uint32)
    from .hashing import table_size

    n = len(hashes)
    if S is None:
        S = table_size(n)
    slots = np.full(S, -1, dtype=np.int32)
    if not n:
        return slots, 1
    mp = int(lib.tpi_hash_build_v2(hashes, n, slots, S))
    return slots, mp


def scan_blocks(words: np.ndarray, outs: np.ndarray, tbs: np.ndarray) -> np.ndarray:
    """Native block-offset scan for the device snapshot builder."""
    lib = _load()
    assert lib is not None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    outs = np.ascontiguousarray(outs, dtype=np.int64)
    tbs = np.ascontiguousarray(tbs, dtype=np.int64)
    flat = np.zeros(int(tbs[-1]), dtype=np.int32)
    rc = lib.tpi_scan_blocks(words, len(words), outs, len(outs), tbs, flat)
    if rc != 0:
        raise ValueError("native scan: malformed posting block")
    return flat
