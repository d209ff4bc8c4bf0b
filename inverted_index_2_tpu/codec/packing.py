"""Posting-list compression codec: delta + per-block horizontal bit-packing.

Vectorizable replacement for the reference's `intcomp.CompressUint32` /
`UncompressUint32` (used at /root/reference/file/writer.go:49 and
/root/reference/file/reader.go:100). The reference delegates to a
FastPFoR-family Go library (delta + binary packing in blocks of 128); we use
the same block structure with a layout whose DECODE is a fixed-shape vector
program (per-lane double-word fetch + shift/mask + cumsum) that runs
identically in numpy (host) and jax.numpy (XLA, on the device).

Layout (all little-endian uint32 words):

    [ n ]                                  total number of values
    then ceil(n/128) blocks, each:
    [ header ]  = bitwidth b (bits 0..7) | block count n_blk (bits 8..15)
    [ anchor ]  = first value of the block, raw
    [ ceil((n_blk-1)*b / 32) packed words ]

Within a block the values v[0..n_blk-1] are strictly increasing (the index
stores sorted unique uint32 postings — see /root/reference/file/types.go:14-22);
we store d[j] = v[j+1] - v[j] - 1 (>= 0) for j in 0..n_blk-2, each in b bits at
bit offset j*b of the packed region (b = bit length of the largest stored
delta; b = 0 when the block is a dense run or a single value — zero packed
words). Density matches intcomp within the 2-words-per-block header cost.

Unlike the reference (which does NOT store run lengths and derives them by
peeking the next term's offset, reader.go:36-69) this layout is
self-delimiting: `n` is stored and every block's size follows from its
header — the device decoder needs explicit offsets, and it removes the
reference Reader's buffer-doubling retry loop (reader.go:79-98).

An empty value list encodes to the single word [0]
(round-trip parity with file/writer_test.go:11-46's empty-values case).
"""
from __future__ import annotations

import numpy as np

BLOCK = 128
# Worst-case words per block window incl. +1 slack word for the double-word
# fetch of the last lane: header + anchor + ceil(127*32/32) + 1.
MAX_BLOCK_WORDS = 2 + 127 + 1
_MASK32 = np.uint64(0xFFFFFFFF)


def _bit_length(x: np.ndarray) -> np.ndarray:
    """Element-wise bit length of uint64 values (0 -> 0)."""
    x = x.astype(np.uint64)
    out = np.zeros(x.shape, dtype=np.int64)
    cur = x.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        mask = cur >= (np.uint64(1) << np.uint64(shift))
        out[mask] += shift
        cur[mask] >>= np.uint64(shift)
    out[x > 0] += 1
    return out


def _packed_words(n_blk: np.ndarray, b: np.ndarray) -> np.ndarray:
    """ceil((n_blk-1)*b / 32) as int64 (elementwise)."""
    nd = np.maximum(np.asarray(n_blk, dtype=np.int64) - 1, 0)
    return (nd * np.asarray(b, dtype=np.int64) + 31) // 32


def encode_postings(values: np.ndarray) -> np.ndarray:
    """Encode one sorted unique uint32 array into codec words (uint32)."""
    values = np.ascontiguousarray(values, dtype=np.uint32)
    n = values.shape[0]
    voffs = np.array([0, n], dtype=np.int64)
    words, _ = encode_bulk(values, voffs)
    return words


def encode_bulk(values: np.ndarray, value_offsets: np.ndarray, byte_align: bool = False):
    """Encode many posting lists at once.

    values[value_offsets[i]:value_offsets[i+1]] is term i's sorted unique list.
    Returns (words uint32, outs int64) with outs[i] = word offset of list i.
    Dispatches to the native C++ codec when built (bit-identical layout);
    falls back to the vectorized numpy implementation below.

    byte_align rounds each block's bit width up: 1/True -> whole bytes
    (b in {0,8,16,24,32}), 2 -> power-of-two bytes ({0,8,16,32}; the device
    arena uses this).
    Same wire layout either way (a byte-multiple b is just a particular b),
    ~15-50% larger, but every delta's bytes land at STATIC word/shift
    positions — the device decoder then needs no dynamic per-lane gather.
    Used for the DEVICE snapshot arena only; the on-disk segment codec
    always stores exact widths (the compression-ratio contract).
    """
    from . import native

    if native.available() and len(value_offsets) > 1:
        return native.encode_bulk(values, value_offsets, int(byte_align))
    return _encode_bulk_np(values, value_offsets, byte_align)


def _encode_bulk_np(values: np.ndarray, value_offsets: np.ndarray, byte_align: bool = False):
    """Vectorized numpy reference implementation of encode_bulk."""
    values = np.ascontiguousarray(values, dtype=np.uint32)
    value_offsets = np.asarray(value_offsets, dtype=np.int64)
    T = len(value_offsets) - 1
    counts = np.diff(value_offsets)
    nb = -(-counts // BLOCK)  # blocks per term (0 for empty lists)
    B = int(nb.sum())
    if B == 0:
        outs = np.arange(T, dtype=np.int64)
        return np.zeros(T, dtype=np.uint32), outs

    bstart = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(nb, out=bstart[1:])
    block_term = np.repeat(np.arange(T, dtype=np.int64), nb)
    block_in_term = np.arange(B, dtype=np.int64) - bstart[block_term]
    s = value_offsets[block_term] + BLOCK * block_in_term
    blen = np.minimum(BLOCK, value_offsets[block_term + 1] - s)
    anchors = values[s]

    # global adjacent deltas (valid only within a term's list)
    if len(values) > 1:
        dg = values[1:].astype(np.int64) - values[:-1].astype(np.int64) - 1
    else:
        dg = np.zeros(0, dtype=np.int64)
    # validate strict monotonicity across WHOLE lists, including positions at
    # 128-value block boundaries (block anchors are stored raw, so the
    # intra-block mask below would otherwise hide a boundary violation —
    # matching the native encoder's whole-list check)
    if len(dg):
        bad = dg < 0
        if bad.any():
            # boundary positions between consecutive LISTS are legitimately
            # non-monotonic; exclude them
            list_ends = value_offsets[1:-1] - 1
            bad[list_ends[(list_ends >= 0) & (list_ends < len(bad))]] = False
            if bad.any():
                raise ValueError("encode requires strictly increasing values per list")
    dg = np.concatenate([dg, np.zeros(BLOCK, dtype=np.int64)])
    jidx = np.arange(BLOCK - 1, dtype=np.int64)
    gidx = s[:, None] + jidx[None, :]
    dvalid = jidx[None, :] < (blen[:, None] - 1)
    d = np.where(dvalid, dg[gidx], 0).astype(np.uint64)

    maxd = d.max(axis=1) if d.shape[1] else np.zeros(B, dtype=np.uint64)
    b = _bit_length(maxd)  # (B,) in [0, 32]
    if byte_align:
        b = ((b + 7) // 8) * 8 * (b > 0)
        if int(byte_align) >= 2:
            b = np.where(b == 24, 32, b)

    pw = _packed_words(blen, b)          # packed words per block
    block_words = 2 + pw
    cw = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(block_words, out=cw[1:])
    term_block_words = cw[bstart[1:]] - cw[bstart[:-1]]
    term_words = 1 + term_block_words
    outs = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(term_words, out=outs[1:])
    total = int(outs[-1])
    out64 = np.zeros(total, dtype=np.uint64)  # accumulate, then cast

    out64[outs[:-1]] = counts.astype(np.uint64)
    within = cw[:-1] - cw[bstart[block_term]]
    block_base = outs[:-1][block_term] + 1 + within
    out64[block_base] = (b | (blen << 8)).astype(np.uint64)
    out64[block_base + 1] = anchors.astype(np.uint64)

    # scatter packed delta bits: delta j sits at bit offset j*b of its block's
    # packed region. Non-overlapping bit fields => per-word SUM == OR, and
    # np.bincount(weights=float64) is exact below 2^53 (word sums < 2^32).
    act = dvalid & (b[:, None] > 0)
    if act.any():
        bb = b[:, None].astype(np.int64)
        bitpos = jidx[None, :] * bb
        w0 = block_base[:, None] + 2 + (bitpos >> 5)
        shift = (bitpos & 31).astype(np.uint64)
        c = d << shift  # < 2^64
        lo = (c & _MASK32).astype(np.float64)
        hi = (c >> np.uint64(32)).astype(np.float64)
        w0f = w0[act].ravel()
        lof = lo[act].ravel()
        hif = hi[act].ravel()
        spill = hif > 0
        idx_all = np.concatenate([w0f, w0f[spill] + 1])
        val_all = np.concatenate([lof, hif[spill]])
        sums = np.bincount(idx_all, weights=val_all, minlength=total)
        out64 += sums.astype(np.uint64)
    return (out64 & _MASK32).astype(np.uint32), outs[:-1]


def decode_postings(words: np.ndarray, offset: int = 0) -> np.ndarray:
    """Decode one posting list starting at word `offset`. Returns uint32."""
    words = np.asarray(words, dtype=np.uint32)
    n = int(words[offset])
    if n == 0:
        return np.zeros(0, dtype=np.uint32)
    vals, counts, voffs = decode_bulk(words, np.array([offset], dtype=np.int64))
    return vals


def encoded_length(words: np.ndarray, offset: int = 0) -> int:
    """Number of words occupied by the posting list at `offset`."""
    words = np.asarray(words, dtype=np.uint32)
    n = int(words[offset])
    nblocks = -(-n // BLOCK)
    pos = offset + 1
    for _ in range(nblocks):
        h = int(words[pos])
        b = h & 0xFF
        n_blk = (h >> 8) & 0xFF
        pos += 2 + int(_packed_words(np.int64(n_blk), np.int64(b)))
    return pos - offset


def scan_term_blocks(words: np.ndarray, outs: np.ndarray):
    """Vectorized scan of block offsets/widths for many terms at once.

    `outs` are word offsets of each term's [n] count word. Returns
    (counts (T,), nblocks (T,), block_off (T, maxnb), block_b (T, maxnb)).
    Used by the bulk decoder (merge path) and the device snapshot builder.
    """
    words = np.asarray(words, dtype=np.uint32)
    outs = np.asarray(outs, dtype=np.int64)
    counts = words[outs].astype(np.int64)
    nblocks = -(-counts // BLOCK)
    maxnb = int(nblocks.max()) if len(nblocks) else 0
    T = len(outs)
    block_off = np.zeros((T, max(maxnb, 1)), dtype=np.int64)
    block_b = np.zeros((T, max(maxnb, 1)), dtype=np.int64)
    cur = outs + 1
    for k in range(maxnb):
        sel = np.nonzero(nblocks > k)[0]
        h = words[cur[sel]].astype(np.int64)
        b = h & 0xFF
        n_blk = (h >> 8) & 0xFF
        block_off[sel, k] = cur[sel]
        block_b[sel, k] = b
        cur[sel] += 2 + _packed_words(n_blk, b)
    return counts, nblocks, block_off, block_b


def decode_bulk(words: np.ndarray, outs: np.ndarray, chunk: int = 65536):
    """Decode many posting lists; returns (values concat, counts, value_offsets).

    Used by the merge/compaction path to materialize all postings of the
    input segments at once (replaces the reference's per-term streaming loop
    at /root/reference/shard.go:168-212). Dispatches to the native C++ codec
    when built; numpy fallback below.
    """
    from . import native

    if native.available() and len(outs) > 0:
        return native.decode_bulk(words, outs)
    return _decode_bulk_np(words, outs, chunk)


def _decode_bulk_np(words: np.ndarray, outs: np.ndarray, chunk: int = 65536):
    """Vectorized numpy reference implementation of decode_bulk."""
    words = np.asarray(words, dtype=np.uint32)
    outs = np.asarray(outs, dtype=np.int64)
    counts, nblocks, block_off, block_b = scan_term_blocks(words, outs)
    total = int(counts.sum())
    voffs = np.zeros(len(outs) + 1, dtype=np.int64)
    np.cumsum(counts, out=voffs[1:])
    out = np.zeros(total, dtype=np.uint32)
    if total == 0:
        return out, counts, voffs

    maxnb = block_off.shape[1]
    wpad = np.concatenate([words, np.zeros(2, dtype=np.uint32)]).astype(np.uint64)
    jidx = np.arange(BLOCK - 1, dtype=np.int64)

    T = len(outs)
    for lo_t in range(0, T, chunk):
        hi_t = min(lo_t + chunk, T)
        c_nb = nblocks[lo_t:hi_t]
        c_off = block_off[lo_t:hi_t]
        c_b = block_b[lo_t:hi_t]
        c_voff = voffs[lo_t:hi_t]
        for k in range(maxnb):
            sel = np.nonzero(c_nb > k)[0]
            if len(sel) == 0:
                continue
            offs_k = c_off[sel, k]
            b_k = c_b[sel, k].astype(np.int64)
            headers = wpad[offs_k].astype(np.int64)
            n_blk = (headers >> 8) & 0xFF
            anchors = wpad[offs_k + 1]
            # per-lane double-word fetch
            bitpos = jidx[None, :] * b_k[:, None]
            # clamp: lanes beyond the block's real deltas (masked below) would
            # otherwise index past the buffer
            w0 = np.minimum(offs_k[:, None] + 2 + (bitpos >> 5), len(wpad) - 2)
            shift = (bitpos & 31).astype(np.uint64)
            combined = wpad[w0] | (wpad[w0 + 1] << np.uint64(32))
            mask = np.where(
                b_k > 0, (np.uint64(1) << b_k.astype(np.uint64)) - np.uint64(1), 0
            ).astype(np.uint64)
            d = (combined >> shift) & mask[:, None]
            dmask = jidx[None, :] < (n_blk[:, None] - 1)
            d = np.where(dmask, d, 0)
            steps = d + np.uint64(1)
            vals = anchors[:, None] + np.concatenate(
                [np.zeros((len(sel), 1), dtype=np.uint64), np.cumsum(steps, axis=1)],
                axis=1,
            )
            vals32 = (vals & _MASK32).astype(np.uint32)
            jall = np.arange(BLOCK)
            vmask = jall[None, :] < n_blk[:, None]
            dst = (c_voff[sel][:, None] + k * BLOCK + jall[None, :])[vmask]
            out[dst] = vals32[vmask]
    return out, counts, voffs


