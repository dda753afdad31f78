"""Atomic, hashed, async checkpoints in the reference's on-disk format.

The counterpart of the reference's ``training/checkpoint.py``; a checkpoint
written by either package restores in the other.  Layout:

  <dir>/step_<n>.tmp/…  →  atomic rename →  <dir>/step_<n>/
     manifest.json   — the step and, per leaf in the reference's order,
                       its path (``jax.tree_util.keystr``'s spelling), file,
                       shape, dtype (numpy's name) and sampled fnv1a hash
     arr_<i>.npy     — one file per leaf, on the host

bfloat16 leaves are written as the reference writes them: their raw 2-byte
words under the ``.npy`` descr ``'<V2'`` and the manifest dtype
``"bfloat16"``; the port reads and writes those words through a ``uint16``
view, with no bfloat16 type in numpy.  ``restore`` hands each leaf back as a
tensor on ``device`` (the card unless the caller asks for the CPU; with no
GPU it raises), whatever device the state was saved from: a restart may
land on another device, the reference's elastic restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels.common import resolve_device
from . import tree as T

_BF16_DESCR = "<V2"


def _fnv1a(data: bytes) -> str:
    h = 0xCBF29CE484222325
    for b in data[:: max(1, len(data) // 65536)]:  # sampled hash for speed
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return f"{h:016x}"


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(host array, numpy dtype name) of a leaf; bfloat16 as its uint16 words."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.uint16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, dict(descr=_BF16_DESCR, fortran_order=False, shape=arr.shape))
        f.write(np.ascontiguousarray(arr).tobytes())


def save(state: Any, step: int, ckpt_dir: str, keep_last: int = 3) -> str:
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = dict(step=step, leaves=[])
    for i, (path, leaf) in enumerate(T.leaves_with_paths(state)):
        arr, dtype = _host(leaf)
        fn = f"arr_{i}.npy"
        _write(os.path.join(tmp, fn), arr, dtype)
        manifest["leaves"].append(
            dict(path=path, file=fn, shape=list(arr.shape), dtype=dtype,
                 hash=_fnv1a(arr.tobytes())))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep_last)
    return final


class _Saver(threading.Thread):
    def __init__(self, *args):
        super().__init__(daemon=True)
        self.args = args
        self.error: Optional[BaseException] = None

    def run(self):
        try:
            save(*self.args)
        except BaseException as e:  # handed to wait_pending, which raises it
            self.error = e


_PENDING: List[_Saver] = []
_PENDING_LOCK = threading.Lock()


def save_async(state: Any, step: int, ckpt_dir: str, keep_last: int = 3) -> threading.Thread:
    """Copy ``state`` to the host now, then write it on a thread; the caller
    may go on updating its tensors in place.  ``wait_pending`` joins."""
    host_state = T.tree_map(
        lambda x: x.detach().to("cpu", copy=True) if torch.is_tensor(x) else np.array(x),
        state)
    t = _Saver(host_state, step, ckpt_dir, keep_last)
    t.start()
    with _PENDING_LOCK:
        _PENDING.append(t)
    return t


def wait_pending() -> None:
    """Join every pending ``save_async``; raise the first save's error."""
    with _PENDING_LOCK:
        pending = list(_PENDING)
        _PENDING.clear()
    for t in pending:
        t.join()
    for t in pending:
        if t.error is not None:
            raise t.error


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                steps.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def _read(path: str, dtype: str) -> np.ndarray:
    arr = np.load(path)
    return arr.view(np.uint16) if dtype == "bfloat16" else arr   # '<V2' words


def _tensor(arr: np.ndarray, dtype: str, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(dev)


def restore(like: Any, ckpt_dir: str, step: Optional[int] = None,
            device: Optional[Union[str, torch.device]] = None,
            verify: bool = True) -> Tuple[Any, int]:
    """Restore into the structure of ``like``: (state, step).  Each leaf is
    a tensor on ``device`` (None: the card).  Raises ``IOError`` on a hash
    mismatch."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    paths = [p for p, _ in T.leaves_with_paths(like)]
    if paths != [m["path"] for m in manifest["leaves"]]:
        raise ValueError(f"checkpoint {d} holds other leaves than the state to restore into")
    out = []
    for meta in manifest["leaves"]:
        arr = _read(os.path.join(d, meta["file"]), meta["dtype"])
        if verify and _fnv1a(arr.tobytes()) != meta["hash"]:
            raise IOError(f"checkpoint corruption in {meta['path']}")
        out.append(_tensor(arr, meta["dtype"], dev))
    return T.unflatten(like, out), manifest["step"]


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
