"""Published model configurations of the port, each with a reduced ``SMOKE``
variant for the CPU tests: ``gemma3_4b`` (LM) and ``dlrm_rm2`` (recsys)."""
