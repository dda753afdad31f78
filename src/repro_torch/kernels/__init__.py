"""Hand-written Hopper kernels of the port (sources in ``csrc/``).

  hop_scatter  the traversal hop: fused gather → temporal mask → segment
               reduce (static/bucket columns and interval cells, with the
               MIN/MAX extremum channel), and the delivery-only scatters of
               ETR hops

Implementation and device selection are uniform (``common.py``):
``impl='torch' | 'cuda'``; a wrapper runs its plain version on CPU tensors
and its kernel on CUDA tensors.  ``build.py`` compiles the sources at first
use.
"""
from .common import IMPLS, check_impl, resolve_device, use_kernels  # noqa: F401
