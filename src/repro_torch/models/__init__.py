"""Model families of the port: the dense LM transformer (``transformer``) and
DLRM (``dlrm``), over the shared layers of ``layers``."""
