"""step_roofline.train, read in epochs with the 512-step prefix."""
from readers import step_roofline as read  # noqa: F401
