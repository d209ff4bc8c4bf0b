"""Serving-snapshot checkpointing: persist the compact host tables behind a
frozen QueryEngine build so a serving restart skips segment scan, k-way
merge, posting re-encode and hash-table build — the expensive half of
``QueryEngine.from_index`` (seconds at 1M terms, tens of seconds at 10M)
— and pays only one file read plus the device upload.

The reference has no analogue: its index IS its checkpoint (immutable
segments + removed.list, /root/reference/shard.go:300-359, SURVEY §5) and
reopen just re-reads FST headers. That property is preserved here (our
segment layer recovers the same way); this module adds the device-serving
warm-start ON TOP, because rebuilding device tables is where our startup
cost lives.

Format: one ``numpy.savez`` archive (version-tagged JSON meta entry + the
HostTables arrays). Publish follows the segment protocol — write
``<path>.tmp`` then atomic ``os.replace`` (file/writer.go:79-86 semantics),
so a crash mid-save never corrupts an existing checkpoint and loaders never
see a partial file.

Staleness is handled by fingerprint, not by trust: the checkpoint embeds the
``_index_fingerprint`` of the index state it froze. ``QueryEngine.
from_checkpoint(path, index=...)`` loads the main tier and then runs the
ordinary ``refresh`` lifecycle against the live index — unchanged index =
no-op, additive drift = O(delta) incremental tier, anything else = full
rebuild. A stale checkpoint is therefore never wrong, only less warm.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from .query_engine import HostTables, _index_fingerprint, snapshot_tables

MAGIC = "tpi-snapshot-checkpoint"
VERSION = 1

# array fields of HostTables, in archive order
_ARRAYS = ("keys", "words", "flat", "tbs", "counts", "removed", "slots")


def _fingerprint_to_json(fp) -> list:
    """(apply_removed, ((shard_key, (seg_key, ...), rl_len), ...)) -> JSON.

    Segment keys are unix-ns decimal strings (segment/writer.py:35) and
    shard keys are "0000".."1023" strings — all JSON-native."""
    apply_removed, parts = fp
    return [bool(apply_removed), [[k, list(segs), int(rl)] for k, segs, rl in parts]]


def _fingerprint_from_json(obj) -> tuple:
    apply_removed, parts = obj
    return (
        bool(apply_removed),
        tuple((k, tuple(segs), int(rl)) for k, segs, rl in parts),
    )


def save_checkpoint(
    index, path: str, apply_removed: bool = False, width: Optional[int] = None
) -> dict:
    """Freeze `index` into compact host tables and persist them at `path`
    (atomic publish). Returns the written meta dict (n_terms, fingerprint,
    ...). The index stays live — segments are pinned only for the freeze."""
    fp = _index_fingerprint(index, apply_removed)
    t = snapshot_tables(index, apply_removed=apply_removed, width=width)
    return save_tables(t, path, fingerprint=fp, apply_removed=apply_removed)


def save_tables(
    t: HostTables, path: str, fingerprint=None, apply_removed: bool = False
) -> dict:
    """Persist prebuilt HostTables (the low-level half of save_checkpoint)."""
    meta = {
        "magic": MAGIC,
        "version": VERSION,
        "width": int(t.width),
        "max_probes": int(t.max_probes),
        "max_count": int(t.max_count),
        "max_bw": int(t.max_bw),
        "apply_removed": bool(apply_removed),
        "n_terms": t.n_terms,
        "fingerprint": None if fingerprint is None else _fingerprint_to_json(fingerprint),
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            meta=np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8),
            **{name: getattr(t, name) for name in _ARRAYS},
        )
        f.flush()
        if os.environ.get("TPI_FSYNC"):
            os.fsync(f.fileno())
    os.replace(tmp, path)
    return meta


def load_checkpoint(path: str) -> Tuple[HostTables, dict]:
    """Read a checkpoint back into (HostTables, meta). Raises ValueError on
    a foreign or future-versioned file (a checkpoint is a cache: callers
    fall back to from_index)."""
    with np.load(path) as z:
        try:
            meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        except Exception as e:  # missing entry / not JSON
            raise ValueError(f"not a tpi checkpoint: {path}") from e
        if meta.get("magic") != MAGIC:
            raise ValueError(f"not a tpi checkpoint: {path}")
        if meta.get("version") != VERSION:
            raise ValueError(
                f"checkpoint version {meta.get('version')} != {VERSION}: {path}"
            )
        arrs = {name: z[name] for name in _ARRAYS}
    t = HostTables(
        **arrs,
        max_probes=int(meta["max_probes"]),
        max_count=int(meta["max_count"]),
        width=int(meta["width"]),
        max_bw=int(meta["max_bw"]),
    )
    if t.keys.ndim != 2 or t.keys.shape[1] != t.width + 1 or len(t.tbs) != t.n_terms + 1:
        raise ValueError(f"checkpoint table shapes inconsistent: {path}")
    return t, meta


def load_fingerprint(meta: dict):
    raw = meta.get("fingerprint")
    return None if raw is None else _fingerprint_from_json(raw)
