"""End-to-end driver on the PyTorch port: generate an LDBC temporal graph,
build statistics, plan with the cost model, serve the 8-template workload,
verify vs the oracle.  The counterpart of ``temporal_queries.py``.

    PYTHONPATH=src python examples/torch_temporal_queries.py [--persons 1000] [--device cpu]

Runs on the card unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it raises.  ``--verify`` is added unless given.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.query import main

if __name__ == "__main__":
    if "--verify" not in sys.argv:
        sys.argv.append("--verify")
    main()
