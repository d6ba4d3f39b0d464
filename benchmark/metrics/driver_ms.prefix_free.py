"""driver_ms.prefix_free, read in prefix-free epochs."""
from readers import driver_ms as read  # noqa: F401
