"""device_idle_pct.prefix_free, read in prefix-free epochs."""
from readers import device_idle_pct as read  # noqa: F401
