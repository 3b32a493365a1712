"""Production and host meshes of the LM mesh path, as
``torch.distributed`` device meshes (the JAX package's ``jax.make_mesh``
meshes, ``repro/launch/mesh.py``).

Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2,
data=16, model=16) = 512 ranks; the ``pod`` axis is outer data
parallelism.  Each mesh is built over the default process group, which
the caller starts first with as many ranks as the mesh has: real ranks
(one per card over NCCL, or ranks sharing the card over ``transport``'s
staged gloo group), or a fake process group for the dry run
(``launch/dryrun.py``).  Functions, not module-level constants, so that
importing this module touches no process group.

The reference's ``make_partition_mesh`` (the 1-D ``("parts",)`` mesh of
the distributed graph path) has its twin in ``dist/comm.py``: one
process per partition over ``torch.distributed`` (``comm.spawn``), so it
is not repeated here.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _mesh(shape, names, device_type):
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device_type)


def make_host_mesh(model_parallel: int = 1, device_type="cuda"):
    """(data = world / model_parallel, model = model_parallel) over every
    rank of the process group."""
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not divide into model parallelism "
                         f"{model_parallel}")
    return _mesh((n // model_parallel, model_parallel), ("data", "model"),
                 device_type)


def axis_sizes(mesh) -> dict:
    """name → size of every mesh dimension, of a ``DeviceMesh`` or of a
    dict of them (a mesh's shape without a process group)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_axes(mesh) -> tuple:
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def model_axis_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)
