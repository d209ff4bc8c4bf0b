"""Serving lifecycle demo: live index -> device snapshot -> mesh fan-out.

Runs on a virtual 8-device CPU mesh (no multi-GPU host needed); on real
hardware the same code spreads the shard axis over the cards. Shows:

  1. ingest + compaction on the live (host) index
  2. QueryEngine serving with O(delta) incremental refresh
  3. multi-device sharded snapshot: fan-out lookup, concat-decode boolean,
     sharded prefix search, globally sorted range read, skew stats

Usage: python examples/serving_mesh.py
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import jax.numpy as jnp

from inverted_index_2_tpu import InvertedIndex
from inverted_index_2_tpu.codec import keys as K
from inverted_index_2_tpu.models.query_engine import QueryEngine
from inverted_index_2_tpu.parallel import mesh as pm


def main():
    ii = InvertedIndex(tempfile.mkdtemp(prefix="mesh_demo_"))
    rng = np.random.default_rng(0)
    vocab = [f"{chr(97 + i % 26)}{chr(97 + (i // 26) % 26)}-term{i:04d}".encode() for i in range(400)]
    for doc in range(1, 301):
        terms = [vocab[i] for i in rng.choice(len(vocab), size=5, replace=False)]
        ii.put(terms, doc)
    while ii.merge(2, 100, 4) > 0:
        pass

    # --- single-device serving with incremental refresh -------------------
    eng = QueryEngine.from_index(ii, L=128)
    print("stats:", eng.stats())
    # two terms that share doc 1 -> guaranteed non-empty intersection
    doc1 = [tv.term for tv in __import__("inverted_index_2_tpu").to_slice(ii.read(None, None)) if 1 in tv.values][:2]
    print("AND", doc1, "->", eng.boolean([doc1], op="and")[0].tolist())
    ii.put([vocab[0], b"zz-breaking-news"], 999)   # fresh write
    eng.refresh(ii)                                # O(delta): delta tier only
    assert eng.delta is not None
    print("fresh term:", eng.lookup([b"zz-breaking-news"])[0].tolist())

    # --- mesh fan-out ------------------------------------------------------
    mesh = pm.default_mesh(8)
    snap = pm.build_sharded_snapshot(ii, mesh)
    # lowercase-ASCII prefixes concentrate in a narrow band of the 10-bit
    # shard-key space; balanced_ranges cuts contiguous ranges at ~equal term
    # counts so real corpora still spread across every device
    print("partition skew:", pm.partition_stats(snap))

    lookup = pm.make_sharded_lookup(snap, L=128)
    qk = jnp.asarray(K.pack_terms([vocab[3], vocab[7]], width=snap.width))
    found, vals, n, raw = lookup(
        snap.keys, snap.blocks, snap.term_block_start, snap.counts, qk
    )
    print("mesh lookup found:", np.asarray(found).tolist())

    booland = pm.make_sharded_boolean_concat(snap, SB=4, op="and")
    bq = np.zeros((8, 2, snap.width + 1), dtype=np.uint32)
    bq[0] = K.pack_terms(doc1, width=snap.width)
    kv = np.zeros(8, dtype=np.int32)
    kv[0] = 2
    out, oc = booland(jnp.asarray(bq), jnp.asarray(kv))
    print("mesh AND:", np.asarray(out)[0, : int(oc[0])].tolist())

    pf = pm.sharded_prefix_search(snap, [vocab[0][:3]], L=128)
    print("mesh prefix:", {k: v[:5].tolist() for k, v in pf.items()})

    # --- MeshQueryEngine: single-chip serving parity on the mesh ----------
    # (tombstone filters, fingerprint refresh with an O(delta) tier,
    # automatic ladder re-serves — bit-identical to QueryEngine)
    from inverted_index_2_tpu.parallel import MeshQueryEngine

    meng = MeshQueryEngine(ii, mesh=mesh, L=128)
    meng.warmup(k_max=3)
    print("mesh engine stats:", meng.stats())
    ii.put_removed([2])
    ii.put([vocab[1], b"zz-more-news"], 1000)
    assert meng.refresh(ii)  # additive + tombstone change -> delta tier
    print("mesh AND (filtered):",
          meng.boolean([doc1], "and", filter_removed=True)[0].tolist())
    print("mesh fresh term:", meng.lookup([b"zz-more-news"])[0].tolist())

    stream = pm.sharded_read_range(snap, vocab[0], vocab[2], L=128)
    print("mesh range read:", [(t, v.tolist()[:3]) for t, v in stream][:3])

    # --- pipelined mesh stream serving -------------------------------------
    # boolean_staged/lookup_staged mirror the single-chip contracts: the
    # pagination form returns TRUE counts + the first prefix_p values per
    # query in one bounded fetch per batch
    (sv, so, sc), = meng.boolean_staged(
        [[doc1, [vocab[1], b"zz-more-news"]]], "or",
        columnar=True, prefix_p=2,
    )
    print("mesh staged OR pages:",
          [(int(sc[i]), sv[so[i]:so[i + 1]].tolist()) for i in range(2)])
    print("mesh staged lookup:",
          [r.tolist() for r in meng.lookup_staged([[vocab[0], b"nope"]])[0]])

    # --- warm restarts: serving-snapshot checkpoints -----------------------
    # One file warm-starts BOTH engines; auto-resave keeps it current on
    # every main-tier rebuild, and a stale file reconciles at load.
    from inverted_index_2_tpu.models import save_checkpoint

    ckpt = tempfile.mktemp(suffix=".ckpt")
    save_checkpoint(ii, ckpt)
    chip = QueryEngine.from_checkpoint(ckpt, index=ii, L=128,
                                       checkpoint_path=ckpt)  # adopt: auto-resave
    warm_mesh = MeshQueryEngine.from_checkpoint(ckpt, index=ii, mesh=mesh, L=128)
    print("warm single-chip:", chip.lookup([b"zz-more-news"])[0].tolist())
    print("warm mesh:", warm_mesh.lookup([b"zz-more-news"])[0].tolist())


if __name__ == "__main__":
    main()
