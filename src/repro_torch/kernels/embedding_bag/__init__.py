from .ops import LAUNCHES, embedding_bag, reset_launches  # noqa: F401
from .ref import embedding_bag_plain  # noqa: F401
