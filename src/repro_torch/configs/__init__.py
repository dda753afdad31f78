"""Published model configurations of the port, each with a reduced ``SMOKE``
variant for the CPU tests: the LMs ``gemma3_4b``, ``minicpm_2b`` and
``llama3_405b`` (the last two with the ``OptCfg`` each trains with, in
``get_arch().meta``), ``dlrm_rm2`` (recsys) and the GNNs ``pna``, ``egnn``,
``meshgraphnet`` and ``schnet`` (whose shapes, ``common.GNN_SHAPES``, they
share)."""
