"""prefix_glue_ms.train, read in epochs with the 512-step prefix."""
from program_readers import prefix_glue_ms as read  # noqa: F401
