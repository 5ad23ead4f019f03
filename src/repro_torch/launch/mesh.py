"""Device meshes: the engine's worker mesh and the model's production
mesh (the port of ``repro.launch.mesh``).

An ``EngineMesh`` is a 1-D list of devices along the worker axis, the
port's counterpart of a ``jax.sharding.Mesh`` whose worker axis a
``NamedSharding(mesh, P("workers"))`` splits: D devices hold W workers in
contiguous blocks of ``W // D``, worker ``w`` on ``devices[w // (W // D)]``.
A device given without an index is the current one, as ``torch`` places a
tensor on ``cuda``. One card can hold every worker (``EngineMesh([torch.device("cuda:0")])``);
``make_engine_mesh(W)`` gives each of W workers a card of its own::

    from repro_torch.launch.mesh import EngineMesh, make_engine_mesh

    mesh = make_engine_mesh(4)                  # cuda:0 ... cuda:3
    mesh.device_of(2, 4)                        # cuda:2
    EngineMesh([torch.device("cpu")]).device_of(3, 4)   # cpu

A ``ModelMesh`` is the counterpart of a multi-axis ``jax.sharding.Mesh``
for the models' sharding policy (``models.sharding``): an array of
devices with an axis name a dimension. A device may repeat, so that one
card, the CPU or ``meta`` stands for many chips while each position still
holds a shard of its own. ``make_production_mesh`` gives the reference's
16 x 16 (``data``, ``model``) or 2 x 16 x 16 (``pod``, ``data``,
``model``) layouts on ``meta`` by default, in place of the reference's
512 forced host devices; ``axes_of`` reads the policy's ``Axes`` off a
mesh::

    mesh = ModelMesh(np.array([torch.device("cuda:0")] * 4).reshape(1, 4),
                     ("data", "model"))
    axes_of(mesh)        # Axes(dp=("data",), tp="model", dp_size=1, tp_size=4)
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from ..device import indexed


class EngineMesh:
    """Devices along the one worker axis (the reference's ``"workers"``)."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("EngineMesh: no devices")
        self.devices: List[torch.device] = [indexed(d) for d in devices]

    @property
    def size(self) -> int:
        """Number of devices along the worker axis."""
        return len(self.devices)

    def check(self, num_workers: int) -> int:
        """Workers each device holds; raises ``ValueError`` unless the
        devices split ``num_workers`` evenly (the reference's
        ``device_put`` onto the mesh fails there too)."""
        if num_workers < 1 or num_workers % self.size:
            raise ValueError(f"EngineMesh: {num_workers} workers do not split "
                             f"evenly over {self.size} devices")
        return num_workers // self.size

    def device_of(self, worker: int, num_workers: int) -> torch.device:
        """The device that holds ``worker`` of ``num_workers``."""
        return self.devices[worker // self.check(num_workers)]

    def worker_devices(self, num_workers: int) -> List[torch.device]:
        """The device of each of ``num_workers`` workers, in worker order."""
        per = self.check(num_workers)
        return [self.devices[w // per] for w in range(num_workers)]

    def __repr__(self) -> str:
        names = [str(d) for d in self.devices]
        return f"EngineMesh({names})"


def make_engine_mesh(num_workers: int) -> EngineMesh:
    """A worker mesh of ``cuda:0`` ... ``cuda:W-1``, one worker a card.
    Raises ``RuntimeError`` when fewer cards are visible."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < num_workers:
        raise RuntimeError(f"make_engine_mesh: {num_workers} workers need as "
                           f"many CUDA devices, {have} visible")
    return EngineMesh([torch.device("cuda", i) for i in range(num_workers)])


class ModelMesh:
    """Devices on named axes: ``devices`` (a numpy object array of
    ``torch.device``s, one a position), ``axis_names``, ``shape`` (name ->
    size, in axis order) and ``size`` (positions)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names) or not arr.size:
            raise ValueError(f"ModelMesh: {arr.ndim}-D devices of "
                             f"{arr.size} for axes {tuple(axis_names)}")
        self.devices = np.empty(arr.shape, dtype=object)
        for pos in itertools.product(*(range(n) for n in arr.shape)):
            self.devices[pos] = indexed(arr[pos])
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def positions(self) -> Iterator[Tuple[int, ...]]:
        """Every position (an index into ``devices``), row-major."""
        return itertools.product(*(range(n) for n in self.devices.shape))

    def device_at(self, position) -> torch.device:
        return self.devices[tuple(position)]

    def position(self, **coords: int) -> Tuple[int, ...]:
        """The position with the given axis coordinates (0 on the
        others)."""
        return tuple(coords.get(a, 0) for a in self.axis_names)

    def __repr__(self) -> str:
        names = sorted({str(d) for d in self.devices.flat})
        return f"ModelMesh({self.shape}, {names})"


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> ModelMesh:
    """16x16 = 256 positions per pod; 2x16x16 = 512 across two pods, every
    position on ``device``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devices = np.empty(shape, dtype=object)
    devices.fill(torch.device(device))
    return ModelMesh(devices, axes)


def axes_of(mesh: ModelMesh):
    """Sharding-policy Axes from a production mesh."""
    from ..models.sharding import Axes

    names = mesh.axis_names
    if "pod" in names:
        dp = ("pod", "data")
    else:
        dp = ("data",)
    dp_size = int(np.prod([mesh.shape[a] for a in dp]))
    return Axes(dp=dp, tp="model", dp_size=dp_size,
                tp_size=int(mesh.shape["model"]))
