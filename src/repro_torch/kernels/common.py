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
"""
from __future__ import annotations

from typing import Optional, Union

import torch

IMPLS = ("torch", "cuda")


def check_impl(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl


def use_kernels(impl: str) -> bool:
    """True for the fused-kernel lowering (the reference's ``use_pallas``)."""
    return check_impl(impl) == "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU explicitly")
    return dev
