"""Implementation and device selection shared by the port's kernel wrappers.

The port's counterpart of the reference package's ``kernels/common.py``:

  impl    'torch'  plain PyTorch ops: the unfused gather → edge weights →
                   segment-sum hop (the reference's ``'xla'``), and the
                   oracle the kernels are held to
          'cuda'   the hand-written Hopper kernels of ``csrc/`` (the
                   reference's ``'pallas'``): fused hops and scatter
                   deliveries

  device  None means ``"cuda"``.  With no GPU, an entry point raises unless
          the caller asks for the CPU explicitly; it never carries on quietly
          on the CPU.  A kernel wrapper given CPU tensors runs its plain
          version (that is how the CPU tests reach the fused path); given CUDA
          tensors it launches its kernel or raises.

  grad    a kernel has no backward: it writes its output through a raw
          pointer, so the output has no ``grad_fn``.  A wrapper asked for the
          kernel (``launches_kernel``) while grad mode is on and an input
          requires grad raises, on either device, rather than drop the
          gradient; ``impl='torch'`` differentiates.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

IMPLS = ("torch", "cuda")
WARP = 32


def check_impl(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl


def use_kernels(impl: str) -> bool:
    """True for the fused-kernel lowering (the reference's ``use_pallas``)."""
    return check_impl(impl) == "cuda"


def launches_kernel(impl: str, what: str, *inputs: Optional[torch.Tensor]) -> bool:
    """True where a wrapper launches its kernel: ``impl`` 'cuda' and the
    first input on the card.  Raises ``RuntimeError`` where ``impl`` is
    'cuda', grad mode is on and an input requires grad, on either device."""
    if check_impl(impl) == "torch":
        return False
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{what}: impl='cuda' runs a kernel with no backward, so the gradient of an "
            "input that requires grad would be dropped; call it with impl='torch' to "
            "differentiate, or under torch.no_grad()")
    return inputs[0].is_cuda


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU explicitly")
    return dev


def lane_group(n_edges: int, n_dst: int, lanes: int) -> int:
    """Edge slots per destination (segment) of the narrow-row kernels B1, B3
    and B5, for an edge that takes ``lanes`` lanes (C / vector width, a power
    of two <= 32; B5 takes 1): the largest power of two G not above half the
    mean arrival degree E / V, between 1 and 32 / lanes, so that the G *
    lanes lanes of a destination fit in a warp and one of typical degree is
    done in about two steps.  Known on the host from the shapes, with no
    device sync; 1 where the kernel has no narrow path (``lanes`` not a
    power of two <= 32)."""
    if lanes < 1 or lanes > WARP or WARP % lanes:
        return 1
    g = 1
    while 2 * g * lanes <= WARP and 4 * g * n_dst <= n_edges:
        g *= 2
    return g
