"""inverted_index_2_tpu — an accelerator-native LSM inverted-index engine.

A from-scratch JAX/XLA re-design of the capabilities of the Go library
lezhnev74/inverted_index_2 (reference mounted at /root/reference): byte-string
terms -> sorted unique uint32 postings, immutable on-disk segments, background
k-way merging with timestamped tombstone purge, 10-bit-prefix sharding, range
reads and prefix search — with the codec/search/merge/query hot paths as
vectorized array programs on the GPU and only I/O + bookkeeping on the host.

Public surface (SURVEY.md §2.4 capability contract):
    InvertedIndex(basedir, enable_logging) .put/.read/.prefix_search/
        .put_removed/.merge
    Shard, shard_key
    TermValues, merge_term_values, compare_term_values
    RemovedLists, unserialize_removed_list
    Pool
    segment writers/readers in .segment, codecs in .codec,
    device kernels in .ops, device query engine in .models,
    mesh sharding in .parallel
"""

from .evictable_pool import Pool
from .inverted_index import InvertedIndex
from .iterators import (
    ClosingIterator,
    MergingIterator,
    SequentialDynamicIterator,
    TermValues,
    compare_term_values,
    merge_term_values,
    to_slice,
)
from .removed_list import RemovedLists, unserialize_removed_list
from .shard import Shard, shard_key

__all__ = [
    "InvertedIndex",
    "Shard",
    "shard_key",
    "TermValues",
    "merge_term_values",
    "compare_term_values",
    "MergingIterator",
    "SequentialDynamicIterator",
    "ClosingIterator",
    "to_slice",
    "RemovedLists",
    "unserialize_removed_list",
    "Pool",
]

__version__ = "0.1.0"
