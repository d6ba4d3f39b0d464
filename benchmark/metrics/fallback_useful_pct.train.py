"""fallback_useful_pct.train, read in epochs with the 512-step prefix."""
from program_readers import fallback_useful_pct as read  # noqa: F401
