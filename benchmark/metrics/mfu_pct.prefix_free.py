"""mfu_pct.prefix_free, read in prefix-free epochs."""
from readers import mfu_pct as read  # noqa: F401
