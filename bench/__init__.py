"""Benchmark of the PyTorch/CUDA query server (``repro_torch``) on an H100."""
