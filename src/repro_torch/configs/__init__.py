"""Published model configurations of the port, each with a reduced ``SMOKE``
variant for the CPU tests: ``gemma3_4b`` (LM), ``dlrm_rm2`` (recsys) and
the GNNs ``pna``, ``egnn``, ``meshgraphnet`` and ``schnet`` (whose shapes,
``common.GNN_SHAPES``, they share)."""
