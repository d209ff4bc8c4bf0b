"""Segment writers: batch-oriented encoders with atomic publish.

The reference streams TermValues one at a time into an FST builder
(/root/reference/file/writer.go:32-59). An array-first design is batch-oriented:
callers hand over whole sorted arrays (terms blob + offsets (+ postings)) and
the writer encodes and publishes in one shot. Two modes, mirroring the
reference exactly:

 * direct mode  (ingestion, writer.go:97-119): one value per term, stored
   inline in `outs`; NO _vals file is created.
 * normal mode  (merge output, writer.go:123-137): per-term posting lists,
   compressed by the block codec, `outs` = word offset of each list.

Publish protocol: write `*_tmp` files, then os.rename both — the _vals file
first, the _dict file last, so a visible _dict always has its _vals
(the reference closes/renames fst and values together, writer.go:61-89).
"""
from __future__ import annotations

import os
import time

import numpy as np

# fsync before publish: OFF by default (the reference's Go writer closes and
# renames without fsync, writer.go:61-89 — the atomic rename orders the
# publish; fsync only matters for power-loss durability). Set TPI_FSYNC=1 to
# force durable segment writes.
_FSYNC = bool(os.environ.get("TPI_FSYNC"))

from ..codec import packing
from . import formats


def new_segment_key() -> str:
    """Unix-nanosecond decimal key (parity: /root/reference/file/writer.go:98).

    time.time_ns() can collide under rapid successive calls on coarse clocks;
    uniqueness within a directory is enforced by the caller retrying.
    """
    return str(time.time_ns())


def _writev(path: str, bufs) -> None:
    """Write buffers to a fresh file with one gathered syscall (no Python
    concat copies); handles partial writes and optional fsync."""
    views = [memoryview(b) for b in bufs if len(b)]
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o666)
    try:
        while views:
            written = os.writev(fd, views)
            while views and written >= views[0].nbytes:
                written -= views[0].nbytes
                views.pop(0)
            if written and views:
                views[0] = views[0].cast("B")[written:]
        if _FSYNC:
            os.fsync(fd)
    finally:
        os.close(fd)


def _write_dict(path: str, mode: int, offsets: np.ndarray, outs, blob, const_out=None) -> None:
    """Encode + write the dict file. `outs` is an ndarray, or (for direct
    mode) all-equal — passed explicitly as `const_out` (then outs may be
    None) or detected as a zero-stride broadcast array — and stored as ONE
    value (FLAG_OUTS_CONST). Fixed-width term sets store the width instead
    of the offsets array (FLAG_FIXED_WIDTH). `blob` may be bytes or a uint8
    ndarray (written zero-copy)."""
    n = len(offsets) - 1
    blob_len = len(blob)
    flags = 0
    off_dt = "<u4" if blob_len < 2**32 else "<u8"
    if off_dt == "<u4":
        flags |= formats.FLAG_OFFSETS_U32
    if const_out is None and n > 0 and isinstance(outs, np.ndarray) \
            and outs.ndim == 1 and outs.strides[0] == 0:
        const_out = int(outs[0])
    if const_out is not None:
        out_max = const_out
    else:
        out_max = 0 if n == 0 else int(np.max(outs))
    out_dt = "<u4" if out_max < 2**32 else "<u8"
    if out_dt == "<u4":
        flags |= formats.FLAG_OUTS_U32
    if const_out is not None:
        flags |= formats.FLAG_OUTS_CONST
        out_arr = np.array([const_out], dtype=out_dt)
    else:
        out_arr = np.ascontiguousarray(outs, dtype=out_dt)
    # fixed-width terms: store just the width
    width = int(offsets[1]) - int(offsets[0]) if n >= 1 else 0
    if n >= 1 and 0 <= width < 2**32 and blob_len == width * n and bool(
        np.all(offsets[1:] == np.arange(1, n + 1, dtype=np.int64) * width)
    ):
        flags |= formats.FLAG_FIXED_WIDTH
        off_arr = np.array([width], dtype=off_dt)
    else:
        off_arr = np.ascontiguousarray(offsets, dtype=off_dt)
    _writev(
        path,
        [formats.pack_header(mode, n, blob_len, flags), off_arr, out_arr, blob],
    )


def _unique_key(basedir: str) -> str:
    while True:
        key = new_segment_key()
        if not os.path.exists(formats.dict_path(basedir, key)):
            return key
        time.sleep(0)


def write_direct_segment(
    basedir: str,
    blob,
    offsets: np.ndarray,
    value: np.uint32,
    key: str | None = None,
) -> str:
    """Write a direct-mode segment: sorted unique terms, one shared value.

    Equivalent of Shard.Put's DirectWriter path (/root/reference/shard.go:33-67):
    one document's terms all carry the same uint32 value. The shared value is
    stored ONCE (FLAG_OUTS_CONST) — no outs array is materialized or written.
    `blob` may be bytes or a uint8 ndarray view (written zero-copy).
    Returns the segment key.
    """
    key = key or _unique_key(basedir)
    tmp = formats.dict_path(basedir, key) + formats.TMP_SUFFIX
    _write_dict(
        tmp, formats.MODE_DIRECT, np.asarray(offsets), None, blob,
        const_out=int(value),
    )
    os.rename(tmp, formats.dict_path(basedir, key))
    return key


def write_direct_segment_outs(
    basedir: str,
    blob,
    offsets: np.ndarray,
    values: np.ndarray,
    key: str | None = None,
) -> str:
    """Direct-mode segment with PER-TERM values (one value per term, values
    differing across terms — the put_many batch shape). Same single-file
    format as write_direct_segment, with a real outs array instead of
    FLAG_OUTS_CONST; the reader already serves both."""
    key = key or _unique_key(basedir)
    tmp = formats.dict_path(basedir, key) + formats.TMP_SUFFIX
    _write_dict(
        tmp, formats.MODE_DIRECT, np.asarray(offsets),
        np.asarray(values, dtype=np.uint64), blob,
    )
    os.rename(tmp, formats.dict_path(basedir, key))
    return key


def write_normal_segment(
    basedir: str,
    blob: bytes,
    offsets: np.ndarray,
    values: np.ndarray,
    value_offsets: np.ndarray,
    key: str | None = None,
) -> str:
    """Write a normal-mode segment from concatenated per-term posting lists.

    values[value_offsets[i]:value_offsets[i+1]] is term i's sorted unique
    posting list (all non-empty). Equivalent of the merge writer path
    (/root/reference/shard.go:196-207 + file/writer.go:43-56).
    Returns the segment key.
    """
    key = key or _unique_key(basedir)
    words, outs = packing.encode_bulk(values, np.asarray(value_offsets, dtype=np.int64))
    return write_normal_segment_words(basedir, blob, offsets, words, outs, key=key)


def write_normal_segment_words(
    basedir: str,
    blob: bytes,
    offsets: np.ndarray,
    words: np.ndarray,
    outs: np.ndarray,
    key: str | None = None,
) -> str:
    """Write a normal-mode segment from already-encoded posting words."""
    key = key or _unique_key(basedir)
    vtmp = formats.vals_path(basedir, key) + formats.TMP_SUFFIX
    with open(vtmp, "wb") as f:
        np.asarray(words, dtype="<u4").tofile(f)
        f.flush()
        if _FSYNC:
            os.fsync(f.fileno())
    dtmp = formats.dict_path(basedir, key) + formats.TMP_SUFFIX
    _write_dict(dtmp, formats.MODE_NORMAL, np.asarray(offsets), np.asarray(outs), blob)
    os.rename(vtmp, formats.vals_path(basedir, key))
    os.rename(dtmp, formats.dict_path(basedir, key))
    return key


class SegmentWriter:
    """Streaming writer: append sorted (term, values) records, then close.

    API parity with the reference's file.Writer (Append/Close/GetKey,
    /root/reference/file/writer.go:32-93) for callers that produce records
    one at a time; internally it batches and publishes through the columnar
    writers on close. Records must arrive in strictly ascending term order
    with sorted unique values (same contract as the reference's FST insert).
    """

    def __init__(self, basedir: str, direct: bool = False, value: int = 0):
        self.basedir = basedir
        self.direct = direct
        self.value = value
        self._terms: list[bytes] = []
        self._values: list[np.ndarray] = []
        self._key: str | None = None
        self._closed = False

    def append(self, term: bytes, values=None) -> None:
        if self._closed:
            raise RuntimeError("writer closed")
        if self._terms and term <= self._terms[-1]:
            raise ValueError("terms must be appended in strictly ascending order")
        self._terms.append(term)
        if not self.direct:
            self._values.append(np.asarray(values if values is not None else [], dtype=np.uint32))

    def close(self) -> str:
        """Encode, publish atomically, return the segment key."""
        if self._closed:
            return self._key
        self._closed = True
        blob, offsets = terms_to_blob(self._terms)
        if self.direct:
            self._key = write_direct_segment(self.basedir, blob, offsets, np.uint32(self.value))
        else:
            voffs = np.zeros(len(self._values) + 1, dtype=np.int64)
            if self._values:
                np.cumsum([len(v) for v in self._values], out=voffs[1:])
            vals = (
                np.concatenate(self._values)
                if self._values
                else np.zeros(0, dtype=np.uint32)
            )
            self._key = write_normal_segment(self.basedir, blob, offsets, vals, voffs)
        return self._key

    def get_key(self) -> str | None:
        return self._key


def terms_to_blob(terms: list[bytes]) -> tuple[bytes, np.ndarray]:
    """Concatenate terms into (blob, offsets[n+1]). Terms must be pre-sorted."""
    blob = b"".join(terms)
    offsets = np.zeros(len(terms) + 1, dtype=np.int64)
    if terms:
        np.cumsum([len(t) for t in terms], out=offsets[1:])
    return blob, offsets
