"""Entry points users start: ``python -m repro_torch.launch.query`` and
``python -m repro_torch.launch.train``."""
