from .device import resolve_device
from .metrics import METRICS, Metrics

__all__ = ["METRICS", "Metrics", "resolve_device"]
