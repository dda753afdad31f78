"""PyTorch/CUDA port of the temporal path-query engine.

A second package beside the JAX reference (``src/repro``): the same module
tree, plain PyTorch for the tensor work, and the reference's Pallas kernels
rewritten by hand in CUDA for Hopper (``csrc/``).  It imports neither JAX nor
the reference package.

Entry points (``core/engine.py``): ``execute``, ``count_results``,
``batch_executable``, ``execute_batch`` and ``execute_batch_out``; the query
server on top of them (``serving.BatchScheduler``, ``launch/query.py``, run
as ``python -m repro_torch.launch.query``).  They run on the card unless the
caller passes ``device='cpu'``, and take ``impl='cuda'`` (the kernels, the
default) or ``impl='torch'`` (plain ops).
"""
