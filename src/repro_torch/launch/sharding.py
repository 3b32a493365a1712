"""Role → DTensor placements (Megatron-style TP, DP/pod batch sharding,
EP for MoE), the reference's ``repro/launch/sharding.py`` function by
function, with its divisibility fallbacks:

  col    — shard output features; fallback: contracting dim (row-parallel
           partial sums); fallback: replicate (odd-head archs: hymba 25H,
           whisper 6H).
  row    — shard contracting dim; fallbacks symmetric.
  embed  — vocab-parallel embedding/unembedding.
  expert — shard the expert dim (EP); fallback: shard expert FFN features.

A spec is the reference's ``PartitionSpec`` as a tuple, one entry per
tensor dim (None, a mesh axis name, or a tuple of names); ``placements``
turns it into one ``Shard(d)`` / ``Replicate()`` per mesh dimension, in
the mesh's order (a dim over ``("pod", "data")`` is ``Shard(d)`` on both,
pod the outer split, as in the reference).  ``mesh`` is a
``DeviceMesh`` or a dict of axis name → size (``mesh.axis_sizes``), so the
placements of a 512-rank mesh can be had without one.  ``distribute``
(``models/sharding_ctx.py``) cuts the full tensors every rank holds into
their DTensors, and ``full_tree`` gathers them back.
"""
from __future__ import annotations

import math

from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models import lm
from repro_torch.models.sharding_ctx import distribute  # noqa: F401
from .mesh import axis_sizes, data_axes, model_axis_size


def placements(spec, mesh) -> list:
    """One placement per mesh dimension for a per-tensor-dim ``spec``."""
    out = []
    for name in axis_sizes(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def _try_dims(shape, dims, parts, axis):
    """First dim in ``dims`` divisible by ``parts`` gets the model axis."""
    nd = len(shape)
    for d in dims:
        dd = d % nd
        if shape[dd] % parts == 0 and shape[dd] >= parts:
            spec = [None] * nd
            spec[dd] = axis
            return tuple(spec)
    return ()


def role_spec(role: str, shape, mesh) -> tuple:
    """The reference's ``role_pspec``: the per-dim spec of a leaf."""
    parts = model_axis_size(mesh)
    ax = "model"
    if parts <= 1:
        return ()
    dims = {"embed": (0, 1), "col": (-1, -2), "row": (-2, -1),
            "col_b": (-1,), "expert_in": (-1,), "expert_down": (-2,),
            "expert": (1, -1, -2)}.get(role)
    return () if dims is None else _try_dims(shape, dims, parts, ax)


def role_pspec(role: str, shape, mesh) -> list:
    """Placements of a parameter of ``role`` and ``shape`` on ``mesh``."""
    return placements(role_spec(role, shape, mesh), mesh)


def param_placements(cfg, mesh):
    return lm.map_defs(lambda _, d: role_pspec(d[1], d[0], mesh),
                       lm.model_defs(cfg))


def distribute_params(params, cfg, mesh):
    """The full parameters every rank holds, cut to their placements."""
    return distribute(params, param_placements(cfg, mesh), mesh)


def batch_pspec(mesh) -> list:
    return placements((data_axes(mesh),), mesh)


def _batch_spec(shape, mesh) -> tuple:
    bd = data_axes(mesh)
    sizes = axis_sizes(mesh)
    spec = [None] * len(shape)
    if spec and shape[0] % max(1, math.prod(sizes[a] for a in bd)) == 0:
        spec[0] = bd
    return tuple(spec)


def batch_placements(specs, mesh):
    """Inputs (name → (shape, dtype)): batch dim over (pod, data) where
    divisible; feature dims replicated."""
    return {k: placements(_batch_spec(s[0], mesh), mesh)
            for k, s in specs.items()}


def _cache_spec(shape, mesh, shard_seq) -> tuple:
    bd = data_axes(mesh)
    sizes = axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in bd)
    parts = model_axis_size(mesh)
    spec = [None] * len(shape)
    if len(shape) >= 2 and shape[1] % dp == 0:
        spec[1] = bd
    if len(shape) == 5:                   # (L, B, S, KV, hd)
        if shape[3] % parts == 0:
            spec[3] = "model"
        elif shard_seq and shape[2] % parts == 0:
            spec[2] = "model"
    return tuple(spec)


def cache_placements(specs, mesh, *, shard_seq=False):
    """Decode caches (name → (shape, dtype)): batch dim (index 1 after the
    layer stack dim) over (pod, data); KV heads over model where
    divisible, else with ``shard_seq`` the cache's sequence dim
    (context-parallel decode)."""
    return {k: placements(_cache_spec(s[0], mesh, shard_seq), mesh)
            for k, s in specs.items()}


def replicated(mesh) -> list:
    return [Replicate()] * len(axis_sizes(mesh))


def local_shape(shape, place, mesh) -> tuple:
    """The shape of rank 0's shard (the largest: DTensor cuts ceil-sized
    pieces first) of a ``shape`` tensor with ``place``."""
    out = list(shape)
    for p, n in zip(place, axis_sizes(mesh).values()):
        if isinstance(p, Shard):
            out[p.dim] = -(-out[p.dim] // n)
    return tuple(out)


def local_bytes(specs, place, mesh) -> int:
    """Bytes of rank 0's shards of the (shape, dtype) leaves ``specs``."""
    if isinstance(specs, dict):
        return sum(local_bytes(v, place[k], mesh) for k, v in specs.items())
    shape, dtype = specs
    return math.prod(local_shape(shape, place, mesh)) * dtype.itemsize


def full_tree(tree):
    """Each DTensor leaf gathered to the full tensor on every rank (a
    collective per leaf: every rank walks the tree in the same order).  A
    replicated leaf's full tensor is its local block itself, not a copy."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_tree(v) for v in tree)
    return tree.full_tensor() if isinstance(tree, DTensor) else tree
