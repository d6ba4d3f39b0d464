"""mega_roofline.train, read in epochs with the 512-step prefix."""
from readers import mega_roofline as read  # noqa: F401
