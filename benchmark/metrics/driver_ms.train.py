"""driver_ms.train, read in epochs with the 512-step prefix."""
from readers import driver_ms as read  # noqa: F401
