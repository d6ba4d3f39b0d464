"""mega_escalated_pct.prefix_free, read in prefix-free epochs."""
from program_readers import mega_escalated_pct as read  # noqa: F401
