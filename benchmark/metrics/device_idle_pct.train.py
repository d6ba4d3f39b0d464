"""device_idle_pct.train, read in epochs with the 512-step prefix."""
from readers import device_idle_pct as read  # noqa: F401
