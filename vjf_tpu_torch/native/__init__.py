"""Streaming input of the port (counterpart of ``vjf_tpu/native``)."""
from .loader import StreamingLoader, device_prefetch

__all__ = ["StreamingLoader", "device_prefetch"]
