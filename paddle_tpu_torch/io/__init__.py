from .device_prefetch import DevicePrefetcher

__all__ = ["DevicePrefetcher"]
