"""launch_host_us.train, read in epochs with the 512-step prefix."""
from program_readers import launch_host_us as read  # noqa: F401
