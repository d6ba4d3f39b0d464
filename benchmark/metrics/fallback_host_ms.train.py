"""fallback_host_ms.train, read in epochs with the 512-step prefix."""
from program_readers import fallback_host_ms as read  # noqa: F401
