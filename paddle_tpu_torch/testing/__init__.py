from . import faults

__all__ = ["faults"]
