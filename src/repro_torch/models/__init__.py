"""Model families of the port: the dense LM transformer (``transformer``),
DLRM (``dlrm``) and the message-passing GNNs (``gnn``), over the shared
layers of ``layers``."""
