from .loader import GraphBuilder, load_graph, save_graph  # noqa: F401
