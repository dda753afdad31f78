"""Published architecture configurations of the port and their registry.

Each module has the reference's ``CONFIG`` (the published configuration),
a reduced ``SMOKE`` variant where the reference has one, and ``get_arch()
-> common.ArchSpec``: id, family, shape names, skipped shapes, a smoke check
and ``meta`` (parameter and active-parameter counts, the ``OptCfg`` it
trains with).  The dense LMs ``gemma3_4b``, ``minicpm_2b`` and
``llama3_405b``; the mixture-of-experts LMs ``olmoe_1b_7b`` and
``mixtral_8x22b``; ``dlrm_rm2`` (recsys); the GNNs ``pna``, ``egnn``,
``meshgraphnet`` and ``schnet`` (whose shapes, ``common.GNN_SHAPES``, they
share); and ``granite_ldbc``, the query engine itself at the paper's
largest graph.
"""
ARCH_IDS = (
    "llama3-405b", "minicpm-2b", "gemma3-4b", "olmoe-1b-7b", "mixtral-8x22b",
    "pna", "egnn", "meshgraphnet", "schnet",
    "dlrm-rm2",
    "granite-ldbc",
)


def load_arch(arch_id: str):
    """``get_arch()`` of ``repro_torch.configs.<arch_id with _ for ->``."""
    import importlib

    mod = importlib.import_module(f"repro_torch.configs.{arch_id.replace('-', '_')}")
    return mod.get_arch()
