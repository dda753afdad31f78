"""Production mesh descriptions.

Defined as functions (never module-level constants) so importing this module
never touches device state.  Single pod = (16, 16) data×model = 256 chips;
multi-pod adds a leading pod axis = (2, 16, 16) = 512 chips.

The port's counterpart of the reference's ``launch/mesh.py``.  A ``Mesh``
here is a plain description, its axis names and sizes: the dry run divides
a cell's shapes by it and models its collectives from it, and nothing
starts a process group or makes a placeholder device for it.
``make_host_mesh`` and ``make_worker_mesh`` lay a mesh over the cards that
are present.

``P`` is the port's partition spec, the counterpart of JAX's
``PartitionSpec``: one entry a dimension, each ``None`` (replicated), an
axis name, or a tuple of axis names (a one-name tuple is kept as the bare
name, as JAX keeps it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch


class P(tuple):
    """A partition spec: ``P(None, "data", ("pod", "data"))``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else e
            return e

        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + (tuple.__repr__(self) if len(self) != 1 else f"({self[0]!r})")

    def axes(self, i: int) -> Tuple[str, ...]:
        """The mesh axes dimension ``i`` is split over (none past the spec)."""
        e = self[i] if i < len(self) else None
        return () if e is None else (e,) if isinstance(e, str) else tuple(e)


def shard_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The block of ``shape`` one device holds under ``spec`` on ``mesh``:
    each dimension divided by the size of the axes it is split over,
    rounded up (XLA's ceil division; the last blocks are padded)."""
    return tuple(-(-int(n) // math.prod(mesh.shape[a] for a in spec.axes(i)))
                 for i, n in enumerate(shape))


def data_axes_of(mesh) -> tuple:
    """Every axis of ``mesh`` but ``model``: the data-parallel axes."""
    return tuple(n for n in mesh.axis_names if n != "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes and their sizes, the leading axis first."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")
        if any(int(s) < 1 for s in self.axis_sizes):
            raise ValueError(f"axis sizes must be positive, got {self.axis_sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(n_data: int = 1, n_model: int = 1) -> Mesh:
    """Small mesh over the cards that are present (tests / benches); raises
    when there are fewer than ``n_data * n_model``."""
    have = torch.cuda.device_count()
    if n_data * n_model > have:
        raise RuntimeError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} cards, "
                           f"{have} present")
    return Mesh(("data", "model"), (n_data, n_model))


def make_worker_mesh(n_devices: int) -> List[torch.device]:
    """The partitioned query engine's worker → device map: worker w on the
    w-th card, in device order.  The order fixes the map, so the
    partitioner's point-to-point lane tables stay valid per process."""
    have = torch.cuda.device_count()
    if n_devices > have:
        raise RuntimeError(f"{n_devices} workers need {n_devices} cards, {have} present")
    return [torch.device("cuda", i) for i in range(n_devices)]
