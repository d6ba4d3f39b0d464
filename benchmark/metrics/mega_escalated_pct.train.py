"""mega_escalated_pct.train, read in epochs with the 512-step prefix."""
from program_readers import mega_escalated_pct as read  # noqa: F401
