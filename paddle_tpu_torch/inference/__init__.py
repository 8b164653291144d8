from .engine import InferenceEngine, Request, default_prefill_buckets

__all__ = ["InferenceEngine", "Request", "default_prefill_buckets"]
