"""Train a reduced MiniCPM (WSD schedule) with checkpoint/restart on the
PyTorch port.  The counterpart of ``train_lm.py``.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--device cpu]

Runs on the card unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it raises.  Interrupt and re-run on the same ``--ckpt-dir``
to see it resume from the last checkpoint (``resumed from step N``).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.train import main

if __name__ == "__main__":
    main()
