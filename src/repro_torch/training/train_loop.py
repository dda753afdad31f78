"""Train steps: loss, gradient and AdamW in one call, with microbatches, and
the data-parallel step with its (optionally compressed) gradient exchange.

The counterpart of the reference's ``training/train_loop.py``.

* ``make_train_step`` — one step: ``loss_fn``'s value and gradient and
  ``apply_updates``.  With ``microbatches`` > 1 the batch's leading axis is
  split into that many equal parts, in order; their gradients are summed
  in float32 and divided by the count, and so are their losses, the
  reference's order.  ``donate`` (the reference's donated buffers) updates
  the parameters and moments in place.
* ``make_dp_train_step`` — the reference's shard_map data-parallel step:
  each rank of a ``torch.distributed`` group takes its shard of the batch,
  and the gradient exchange is ``compression.compressed_psum`` over the
  group (``all_reduce``); with no group set up the world is this process.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from . import tree as T
from .compression import CompressionCfg, compressed_psum, init_error_state, world
from .optimizer import OptCfg, apply_updates, init_state


def value_and_grad(loss_fn: Callable, params, batch) -> Tuple[torch.Tensor, Any]:
    """(loss, gradient tree shaped like ``params``), the reference's
    ``jax.value_and_grad(loss_fn)(params, batch)``: gradients in each
    parameter's dtype, zeros for a parameter the loss does not use; the
    caller's tensors are not marked."""
    flat = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(T.unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return loss.detach(), T.unflatten(params, grads)


def _split(batch, microbatches: int):
    """The batch's leading axis in ``microbatches`` equal parts, in order."""
    n = T.leaves(batch)[0].shape[0]
    if n % microbatches:
        raise ValueError(f"batch of {n} does not split into {microbatches} microbatches")
    size = n // microbatches
    return [T.tree_map(lambda x: x[i * size:(i + 1) * size], batch)
            for i in range(microbatches)]


def make_train_step(loss_fn: Callable[[Any, Dict], torch.Tensor], opt_cfg: OptCfg,
                    microbatches: int = 1, donate: bool = True):
    """``loss_fn(params, batch)`` → scalar.  Returns ``step(params,
    opt_state, batch)`` → (params, opt_state, dict(loss, lr, grad_norm))."""

    def step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            loss = None
            grads = T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                     device=p.device), params)
            for mb in _split(batch, microbatches):
                l, g = value_and_grad(loss_fn, params, mb)
                grads = T.tree_map(torch.add, grads, g)
                loss = l if loss is None else loss + l
                del g
            loss = loss / microbatches
            grads = T.tree_map(lambda g: g / microbatches, grads)
        new_params, new_state, metrics = apply_updates(opt_cfg, params, grads, opt_state,
                                                       inplace=donate)
        return new_params, new_state, dict(loss=loss, **metrics)

    return step


def make_dp_train_step(loss_fn: Callable[[Any, Dict], torch.Tensor], opt_cfg: OptCfg,
                       group=None, compression: Optional[CompressionCfg] = None):
    """Data-parallel step over ``group`` (the default group when one is set
    up, else this process alone): ``step(params, opt_state, err, batch)``
    with this rank's shard of the batch → (params, opt_state, err,
    dict(loss, lr, grad_norm)); the loss is the mean over ranks."""
    comp = compression or CompressionCfg(kind="none")

    def step(params, opt_state, err, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        grads, new_err = compressed_psum(comp, grads, err, group)
        n, _ = world(group)
        if n > 1:
            torch.distributed.all_reduce(loss, group=group)
        loss = loss / n
        new_params, new_state, metrics = apply_updates(opt_cfg, params, grads, opt_state)
        return new_params, new_state, new_err, dict(loss=loss, **metrics)

    return step


def train_state_init(params, opt_cfg: OptCfg, with_err: bool = False):
    st = init_state(params)
    if with_err:
        return st, init_error_state(params)
    return st
