from .engine import InferenceEngine, Request, default_prefill_buckets
from .loadgen import SharedPrefixWorkload, run_loadtest
from .paged_kv import (BlockAllocator, PagedKVCache, blocks_for,
                       init_paged_cache)
from .prefix_cache import RadixPrefixCache

__all__ = ["InferenceEngine", "Request", "default_prefill_buckets",
           "BlockAllocator", "PagedKVCache", "RadixPrefixCache",
           "blocks_for", "init_paged_cache", "SharedPrefixWorkload",
           "run_loadtest"]
