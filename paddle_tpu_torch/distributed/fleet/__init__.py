from .strategy import DistributedStrategy

__all__ = ["DistributedStrategy"]
