"""The engine's device mesh (the port of ``repro.launch.mesh``'s
``make_engine_mesh``).

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
"""

from __future__ import annotations

from typing import List, Sequence

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
