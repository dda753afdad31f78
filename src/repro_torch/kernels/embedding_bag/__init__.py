from .ops import LAUNCHES, embedding_bag, embedding_bags, reset_launches  # noqa: F401
from .ref import embedding_bag_plain, embedding_bags_plain  # noqa: F401
