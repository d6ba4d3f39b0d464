"""mega_roofline.prefix_free, read in prefix-free epochs."""
from readers import mega_roofline as read  # noqa: F401
