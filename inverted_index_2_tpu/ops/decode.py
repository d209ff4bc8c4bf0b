"""On-device posting-list decode (bit-plane codec, jax.numpy program).

Decodes the codec/packing.py layout (delta + per-block bit-planes) for a BATCH
of terms into a fixed-shape (Q, L) padded matrix — the device replacement for
the reference's per-term `intcomp.UncompressUint32` call
(/root/reference/file/reader.go:100). The sequential block-offset scan of the
file layout is precomputed at snapshot-build time into a flat `block_woff`
array, so the device program is pure gathers + shifts + masked adds + cumsum:
no data-dependent shapes, everything static for XLA.

Layout recap per block (see codec/packing.py): [header(b | n_blk<<8), anchor,
b*4 plane words]; delta-1 values, 128 lanes, plane word w*4+g packs bit w of
lanes g*32..g*32+31.
"""
from __future__ import annotations

import jax.numpy as jnp

BLOCK = 128
WIN = 2 + 127 + 1  # worst-case block window incl. +1 slack for double fetch


def decode_blocks(window: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Decode block windows -> (values (..., 128) uint32, n_blk (...,) int32).

    window: (..., WIN) uint32 — [header, anchor, packed...] (garbage beyond
    the block's own packed words is masked off via the header's bitwidth).
    Horizontal layout: delta j occupies bits [j*b, j*b+b) of the packed
    region; decoded with a per-lane double-word fetch — all uint32 ops
    (no 64-bit arithmetic): lo = word[w0] >> s, hi = word[w0+1] << (32-s).
    """
    header = window[..., 0]
    b = (header & 0xFF).astype(jnp.int32)          # (...,)
    n_blk = ((header >> 8) & 0xFF).astype(jnp.int32)
    anchor = window[..., 1]

    j = jnp.arange(BLOCK, dtype=jnp.int32)          # lane = delta index
    bitpos = j * b[..., None]                        # (..., 128)
    w0 = 2 + (bitpos >> 5)
    s = (bitpos & 31).astype(jnp.uint32)
    g0 = jnp.take_along_axis(window, w0, axis=-1)
    g1 = jnp.take_along_axis(window, w0 + 1, axis=-1)
    lo = g0 >> s
    hi = jnp.where(s > 0, g1 << (jnp.uint32(32) - s), jnp.uint32(0))
    mask = jnp.where(
        b > 0,
        jnp.uint32(0xFFFFFFFF) >> (jnp.uint32(32) - jnp.minimum(b, 32).astype(jnp.uint32)),
        jnp.uint32(0),
    )
    d = (lo | hi) & mask[..., None]

    # v[0] = anchor; v[k+1] = v[k] + d[k] + 1
    steps = d[..., : BLOCK - 1] + jnp.uint32(1)
    csum = jnp.cumsum(steps, axis=-1, dtype=jnp.uint32)
    vals = anchor[..., None] + jnp.concatenate(
        [jnp.zeros((*csum.shape[:-1], 1), dtype=jnp.uint32), csum], axis=-1
    )
    return vals, n_blk


def decode_blocks_ba(window: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Byte-aligned decode: window blocks encoded with b in {0,8,16,24,32}
    (codec encode_bulk(byte_align=True), the DEVICE arena layout).

    With whole-byte widths every delta's bytes sit at STATIC word positions,
    so extraction is strided slices + shifts + interleaves — zero dynamic
    gathers (the generic decode_blocks needs a per-lane take_along_axis).
    All four byte classes are decoded unconditionally (cheap elementwise
    work) and selected by each block's class.
    """
    header = window[..., 0]
    b = (header & 0xFF).astype(jnp.int32)
    cls = b >> 3  # bytes per delta: 0..4
    n_blk = ((header >> 8) & 0xFF).astype(jnp.int32)
    anchor = window[..., 1]
    W = window.shape[-1]

    def sl(lo, hi, step=1):
        """Static slice clipped to the window, zero-padded to full length.
        Narrow windows (arena stride < worst-case) are valid as long as every
        real block fits; lanes past a block's packed words are masked by
        n_blk downstream."""
        hi_c = min(hi, W)
        part = window[..., lo:hi_c:step]
        want = -(-(hi - lo) // step)
        if part.shape[-1] < want:
            pad = jnp.zeros((*part.shape[:-1], want - part.shape[-1]), dtype=jnp.uint32)
            part = jnp.concatenate([part, pad], axis=-1)
        return part

    def interleave(parts):
        # parts: list of (..., G) arrays -> (..., G*len) interleaved
        st = jnp.stack(parts, axis=-1)
        return st.reshape(*st.shape[:-2], -1)

    # class 1: words 2..34, 4 deltas per word
    w = sl(2, 34)
    d1 = interleave([w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF, w >> 24])
    # class 2: words 2..66, 2 deltas per word
    w = sl(2, 66)
    d2 = interleave([w & 0xFFFF, w >> 16])
    # class 3: 3 words carry 4 deltas; groups of 32. Contiguous slice +
    # reshape instead of stride-3 slices (strided slices lower to gathers).
    w012 = sl(2, 98).reshape(*window.shape[:-1], 32, 3)
    w0 = w012[..., 0]
    w1 = w012[..., 1]
    w2 = w012[..., 2]
    d3 = interleave(
        [
            w0 & 0xFFFFFF,
            (w0 >> 24) | ((w1 & 0xFFFF) << 8),
            (w1 >> 16) | ((w2 & 0xFF) << 16),
            w2 >> 8,
        ]
    )
    # class 4: one word per delta
    d4 = sl(2, 130)

    c = cls[..., None]
    d = jnp.where(c == 1, d1, jnp.uint32(0))
    d = jnp.where(c == 2, d2, d)
    d = jnp.where(c == 3, d3, d)
    d = jnp.where(c == 4, d4, d)

    steps = d[..., : BLOCK - 1] + jnp.uint32(1)
    csum = _prefix_sum(steps)
    vals = anchor[..., None] + jnp.concatenate(
        [jnp.zeros((*csum.shape[:-1], 1), dtype=jnp.uint32), csum], axis=-1
    )
    return vals, n_blk


def _prefix_sum(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive prefix sum along the last axis via Hillis-Steele doubling
    (concat + slice + add only: log2(128)=7 elementwise adds that XLA
    fuses with the decode around them)."""
    n = x.shape[-1]
    s = 1
    while s < n:
        pad = jnp.zeros((*x.shape[:-1], s), dtype=x.dtype)
        x = x + jnp.concatenate([pad, x[..., : n - s]], axis=-1)
        s <<= 1
    return x


def gather_postings(
    words: jnp.ndarray,
    block_woff: jnp.ndarray,
    term_block_start: jnp.ndarray,
    counts: jnp.ndarray,
    term_idx: jnp.ndarray,
    L: int,
    byte_aligned: bool = False,
):
    """Decode postings of `term_idx` terms into a (Q, L) padded matrix.

    words:            (M,) uint32 — the snapshot's packed posting words
                      (padded by >= WIN trailing zeros by the snapshot builder)
    block_woff:       (B,) int32 — word offset of every block, in term order
    term_block_start: (N+1,) int32 — first block index of each term
    counts:           (N,) int32 — posting count per term
    term_idx:         (Q,) int32 — which terms to decode
    L:                static pad length (multiple of 128); values beyond a
                      term's count are UNDEFINED — consumers mask by count.

    Returns (vals (Q, L) uint32, counts (Q,) int32 — RAW, may exceed L;
    a count > L means the row holds the first L postings and the caller
    must re-serve at a larger L for exactness).
    """
    assert L % BLOCK == 0
    K = L // BLOCK
    tbs = term_block_start[term_idx]          # (Q,)
    n = counts[term_idx]                       # (Q,)
    nb = (n + BLOCK - 1) // BLOCK

    k = jnp.arange(K, dtype=jnp.int32)
    g = tbs[:, None] + jnp.minimum(k[None, :], jnp.maximum(nb[:, None] - 1, 0))
    woff = block_woff[g]                       # (Q, K)
    win = words[woff[..., None] + jnp.arange(WIN, dtype=jnp.int32)]  # (Q, K, WIN)
    decode = decode_blocks_ba if byte_aligned else decode_blocks
    vals, _ = decode(win)                      # (Q, K, 128)
    return vals.reshape(vals.shape[0], K * BLOCK), n


def gather_postings_arena(
    blocks: jnp.ndarray,
    term_block_start: jnp.ndarray,
    counts: jnp.ndarray,
    term_idx: jnp.ndarray,
    L: int,
):
    """Arena variant of gather_postings: blocks pre-copied into a fixed-stride
    (B, stride) matrix at snapshot build. A whole-ROW gather reads contiguous
    rows instead of the elementwise window gather from the flat words array,
    at a memory cost of stride/avg_block_words.
    Blocks are byte-aligned (decode_blocks_ba). Returned counts are RAW (may
    exceed L — see gather_postings).
    """
    assert L % BLOCK == 0
    K = L // BLOCK
    tbs = term_block_start[term_idx]
    n = counts[term_idx]
    nb = (n + BLOCK - 1) // BLOCK
    k = jnp.arange(K, dtype=jnp.int32)
    g = tbs[:, None] + jnp.minimum(k[None, :], jnp.maximum(nb[:, None] - 1, 0))
    win = blocks[g]                             # (Q, K, stride) row gather
    vals, _ = decode_blocks_ba(win)
    return vals.reshape(vals.shape[0], K * BLOCK), n
