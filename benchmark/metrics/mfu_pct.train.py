"""mfu_pct.train, read in epochs with the 512-step prefix."""
from readers import mfu_pct as read  # noqa: F401
