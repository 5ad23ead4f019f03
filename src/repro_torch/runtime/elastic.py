"""Elastic scaling: reshard a training state across mesh shapes, the port
of ``repro/runtime/elastic.py``.

Checkpoints carry whole host arrays (``checkpoint.ckpt``), so scaling from
N to M positions is: make the new ``launch.mesh.ModelMesh``, derive the
new placements from the same policy (``models.sharding
.params_shardings``), restore. ``reshard_state`` does it in memory (no
disk), for a planned rescale; ``restore_for_mesh`` from the newest
checkpoint. A leaf placed earlier (a ``ShardedTensor``) is assembled on
the host first, so any layout goes to any other, bit for bit::

    state = reshard_state(state, ModelMesh(devs.reshape(2, 2),
                                           ("data", "model")))
"""

from __future__ import annotations

import torch

from ..launch.mesh import axes_of
from ..models import sharding as shp


def _host(x):
    """A leaf on the host, whole."""
    return x.full(torch.device("cpu")) if isinstance(x, shp.ShardedTensor) \
        else x.cpu()


def _place(tree, mesh):
    shardings = shp.params_shardings(tree, axes_of(mesh), mesh)
    return shp.tree_map(lambda _, x, sh: shp.device_put(x, sh), tree,
                        shardings)


def reshard_state(state, new_mesh):
    """Re-place every leaf of ``state`` for ``new_mesh`` (in-memory
    path): each leaf a ``ShardedTensor`` on the mesh's positions."""
    return _place(shp.tree_map(lambda _, x: _host(x), state), new_mesh)


def restore_for_mesh(ckpt_dir: str, template, new_mesh):
    """Disk path: the newest checkpoint in ``ckpt_dir`` (the structure of
    ``template``, whose leaves may be placed) restored and placed on
    ``new_mesh`` -> ``(step, state, extra)``, or ``(None, None, None)``
    when there is none."""
    from ..checkpoint.ckpt import restore_latest

    # host stand-ins of the template's leaves: shape and dtype, no bytes
    host = shp.tree_map(lambda _, x: torch.empty((), dtype=x.dtype).expand(
        tuple(x.shape)), template)
    step, state, extra = restore_latest(ckpt_dir, host)
    if state is None:
        return None, None, None
    return step, _place(state, new_mesh), extra
