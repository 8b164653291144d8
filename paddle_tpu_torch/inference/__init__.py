from .disagg import DisaggServingEngine, PrefillWorker
from .engine import InferenceEngine, Request, default_prefill_buckets
from .loadgen import (MultiTenantWorkload, SharedPrefixWorkload,
                      run_fleet_loadtest, run_loadtest, warm_fleet)
from .paged_kv import (BlockAllocator, PagedKVCache, blocks_for,
                       init_paged_cache)
from .prefix_cache import RadixPrefixCache, score_overlap
from .router import Router

__all__ = ["InferenceEngine", "Request", "default_prefill_buckets",
           "BlockAllocator", "PagedKVCache", "RadixPrefixCache",
           "blocks_for", "init_paged_cache", "SharedPrefixWorkload",
           "run_loadtest", "Router", "DisaggServingEngine",
           "PrefillWorker", "score_overlap", "MultiTenantWorkload",
           "run_fleet_loadtest", "warm_fleet"]
