"""Mesh context for in-model sharding constraints (the reference's
``repro/models/sharding_ctx.py``).

Model code is mesh-agnostic; the mesh steps (``launch/steps.py``)
register the active ``DeviceMesh`` here, and layers call ``constrain_*``
to pin the Megatron pattern (batch over (pod, data), heads over model)
instead of leaving DTensor's propagation to pick.  Each is a
``redistribute`` of a DTensor to the reference's spec; with no mesh
registered, or on a plain tensor, it is the identity, as in the
reference.

``write_at`` and ``assign`` are the decode caches' in-place writes
(``index_copy_`` and ``copy_`` on a plain tensor).  On a DTensor cache
each rank writes its own shard, and along a sharded sequence dim
(``shard_cache_seq``) only the rank that owns the position writes; the
position stays on the device, never read on the host.

The rest run a piece of the model on each rank's own block of its
DTensors, where DTensor's op rules would move whole tensors, or differ
between torch releases: ``per_rank`` (the WKV loop), ``pad_seq`` (the
token shift and the causal conv), ``embed_rows`` (a vocab-parallel
lookup), ``split_heads`` / ``merge_heads`` (heads a mesh axis does not
divide).  Each local block whose gradient is a sum over ranks is marked
so (``_grad_place``).  On plain tensors each is the plain op.

``distribute`` cuts full tensors into DTensors, each rank copying its
own block (``local_block``): the parameters' first placement
(``launch/sharding.py``) and a checkpoint's restore onto a mesh
(``checkpoint/manager.py``).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

_MESH = None


def set_mesh(mesh):
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


def _batch_axes():
    return tuple(a for a in _MESH.mesh_dim_names if a in ("pod", "data"))


def _parts():
    names = _MESH.mesh_dim_names
    return _MESH.mesh.shape[names.index("model")] if "model" in names else 1


def constrain(x, spec):
    """``x`` redistributed to the per-dim ``spec``, and its cotangent in
    the backward too, as ``with_sharding_constraint`` constrains both (a
    gradient left partial, as the vocab-parallel head's is, would make
    every later matmul's backward gather its weight).  The identity with
    no mesh or on a plain tensor."""
    if _MESH is None or not isinstance(x, DTensor):
        return x
    from repro_torch.launch.sharding import placements
    want = placements(spec, _MESH)
    if tuple(x.placements) != tuple(want):
        x = x.redistribute(_MESH, want)
    return DTensor.from_local(x.to_local(), _MESH, want, run_check=False,
                              shape=x.shape, stride=x.stride())


def split_heads(x, H: int, hd: int):
    """x (B, S, H·hd) → (B, S, H, hd).  A DTensor sharded on its feature
    dim over more ranks than divide H (chatglm3's 2 KV heads over 16) is
    gathered on that dim first, where GSPMD reshards it on its own."""
    if isinstance(x, DTensor):
        last = x.ndim - 1
        sharded = [isinstance(p, Shard) and p.dim == last
                   for p in x.placements]
        n = 1
        for on, size in zip(sharded, x.device_mesh.mesh.shape):
            n *= size if on else 1
        if H % n:
            x = x.redistribute(x.device_mesh, [
                Replicate() if on else p
                for on, p in zip(sharded, x.placements)])
    return x.reshape(*x.shape[:-1], H, hd)


def merge_heads(x):
    """(B, S, H, hd) → (B, S, H·hd).  On a DTensor whose heads the model
    axis does not divide, the merged tensor and its cotangent are pinned
    whole over model: the feature-sharded cotangent the next matmul sends
    back could not be cut into heads."""
    out = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if (isinstance(out, DTensor) and _MESH is not None
            and x.shape[-2] % _parts()):
        out = constrain(out, (_batch_axes(),) + (None,) * (out.ndim - 1))
    return out


def constrain_hidden(x):
    """(B, S, D) — batch over data axes.  With the ``seq_parallel`` perf
    option on, residual activations between blocks are also sharded
    along sequence over model (Megatron SP)."""
    if _MESH is None:
        return x
    from .common import perf_option
    parts = _parts()
    if (perf_option("seq_parallel") and x.ndim == 3 and parts > 1
            and x.shape[1] % parts == 0 and x.shape[1] >= parts):
        return constrain(x, (_batch_axes(), "model", None))
    return constrain(x, (_batch_axes(),) + (None,) * (x.ndim - 1))


def constrain_heads(x):
    """(B, S, H, hd) — shard heads over model when divisible."""
    if _MESH is None:
        return x
    parts = _parts()
    if x.ndim == 4 and x.shape[2] % parts == 0 and x.shape[2] >= parts:
        return constrain(x, (_batch_axes(), None, "model", None))
    return constrain(x, (_batch_axes(), None, None, None))


def constrain_attn_q(x):
    """Query tensor: head-sharded when divisible; otherwise sequence-
    sharded over model (context parallelism for odd-head archs)."""
    if _MESH is None:
        return x
    parts = _parts()
    if x.ndim == 4 and x.shape[2] % parts == 0 and x.shape[2] >= parts:
        return constrain(x, (_batch_axes(), None, "model", None))
    if x.ndim == 4 and x.shape[1] % parts == 0 and x.shape[1] >= parts:
        return constrain(x, (_batch_axes(), "model", None, None))
    return constrain(x, (_batch_axes(), None, None, None))


def constrain_ff(x):
    """(B, S, FF) — shard the expanded feature dim over model."""
    if _MESH is None:
        return x
    if x.shape[-1] % _parts() == 0:
        return constrain(x, (_batch_axes(), None, "model"))
    return x


def constrain_moe_buf(buf):
    """(B, E, cap, D) dispatch buffer: batch over data axes only (the
    reference's measured choice: the expert products take their model
    parallelism from the ff-sharded expert weights)."""
    if _MESH is None:
        return buf
    return constrain(buf, (_batch_axes(), None, None, None))


def constrain_whole(x):
    """(B, S, F) — batch over data axes, the rest whole: before a split
    of a feature dim that model shards (mamba's x | gate), which would
    leave DTensor choosing a batch-over-model layout that the scan's
    Di split then has to undo across ranks."""
    if _MESH is None:
        return x
    return constrain(x, (_batch_axes(),) + (None,) * (x.ndim - 1))


def constrain_scan(dA, dBx, C):
    """The selective scan's operands, dA/dBx (B, S, N, Di) and C (B, S,
    N): batch over the data axes, Di over model where divisible (C
    whole), so each rank scans its own (B/dp, S, N, Di/mp) block."""
    if _MESH is None:
        return dA, dBx, C
    di = "model" if dA.shape[-1] % _parts() == 0 else None
    spec = (_batch_axes(), None, None, di)
    return (constrain(dA, spec), constrain(dBx, spec),
            constrain(C, (_batch_axes(), None, None)))


def local_block(shape, mesh, place):
    """(local shape, global offset) of this rank's block of a ``shape``
    tensor with placements ``place`` (DTensor's cut: ceil-sized pieces
    in rank order, nested in mesh-dimension order), on the host."""
    coord = mesh.get_coordinate()
    size, off = list(shape), [0] * len(shape)
    for md, p in enumerate(place):
        if isinstance(p, Shard):
            d, full = p.dim % len(shape), size[p.dim % len(shape)]
            step = -(-full // mesh.size(md))
            start = min(coord[md] * step, full)
            size[d] = min(full, start + step) - start
            off[d] += start
    return size, off


def distribute(tree, place, mesh, device=None):
    """Every tensor leaf of ``tree`` as a DTensor with the placements of
    the same leaf of ``place``: each rank copies its own block of the
    full tensor it holds (the same on every rank: no data moves, and the
    DTensor owns its memory, so in-place steps leave ``tree`` alone).
    Trees nest dicts, lists and tuples; a leaf that is no tensor (an
    AdamW step count) stays as it is, and a tensor whose placements are
    ``None`` stays a plain tensor.  With ``device`` each block (and each
    plain tensor) is cut on the tensor's device and then moved there.
    A ``None`` in ``place`` where ``tree`` has a subtree keeps the whole
    subtree plain (a launcher checkpoint's compression state)."""
    if isinstance(tree, dict):
        return {k: distribute(v, None if place is None else place[k], mesh,
                              device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        place = [None] * len(tree) if place is None else place
        return type(tree)(distribute(v, p, mesh, device)
                          for v, p in zip(tree, place))
    if not isinstance(tree, torch.Tensor):
        return tree
    if place is None:
        return tree if device is None else tree.to(device)
    size, off = local_block(tree.shape, mesh, place)
    local = tree.detach()
    for d, (n, o) in enumerate(zip(size, off)):
        local = local.narrow(d, o, n)
    local = local.clone(memory_format=torch.contiguous_format)
    if device is not None:
        local = local.to(device)
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=tree.shape,
                              stride=tree.contiguous().stride())


def _replicated_as(value, like):
    """``value`` (a DTensor, or a plain tensor taken as replicated) on
    ``like``'s mesh."""
    if isinstance(value, DTensor):
        return value
    return DTensor.from_local(value, like.device_mesh,
                              [Replicate()] * like.device_mesh.ndim,
                              run_check=False)


def write_at(buf, dim: int, at, value):
    """``buf.index_copy_(dim, at, value)`` with ``at`` a one-element index
    tensor.  On a DTensor ``buf``, ``value`` is redistributed to ``buf``'s
    placements with ``dim`` whole, and each rank writes its shard where
    it holds position ``at`` (a sharded ``dim``: the owning rank only)."""
    if not isinstance(buf, DTensor):
        buf.index_copy_(dim, at, value)
        return
    mesh = buf.device_mesh
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in buf.placements]
    v = _replicated_as(value, buf).redistribute(mesh, want).to_local()
    local = buf.to_local()
    n = local.shape[dim]
    if n == 0:
        return
    _, offset = local_block(buf.shape, mesh, buf.placements)
    at = at.to_local() if isinstance(at, DTensor) else at
    rel = at - offset[dim]
    idx = rel.clamp(0, n - 1)
    mine = (rel >= 0) & (rel < n)
    local.index_copy_(dim, idx, torch.where(mine, v,
                                            local.index_select(dim, idx)))


def assign(dst, src):
    """``dst.copy_(src)``; on a DTensor ``dst``, ``src`` redistributed to
    its placements first and each rank copying its shard."""
    if not isinstance(dst, DTensor):
        dst.copy_(src)
        return
    src = _replicated_as(src, dst).redistribute(dst.device_mesh,
                                                dst.placements)
    dst.to_local().copy_(src.to_local())


class _SumOver(torch.autograd.Function):
    """Each rank's summand (local) → the sum over the mesh dims where
    ``place`` is ``Partial`` (local of the reduced DTensor).  Every rank's
    summand gets the whole cotangent, whatever DTensor version turns a
    replicated gradient back into a partial one."""

    @staticmethod
    def forward(ctx, local, mesh, place):
        d = DTensor.from_local(local, mesh, place, run_check=False)
        return d.redistribute(mesh, [Replicate() if p.is_partial() else p
                                     for p in place]).to_local()

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _grad_place(arg, main, place=None):
    """Placements of the gradient of ``arg``'s local block when each rank
    computes with it on its own block of ``main``: partial (summed over
    ranks) on every mesh dim where ``arg`` is whole but ``main`` is cut,
    ``arg``'s (or ``place``'s) own elsewhere."""
    place = arg.placements if place is None else place
    return [Partial() if not isinstance(p, Shard) and isinstance(m, Shard)
            else p for p, m in zip(place, main.placements)]


def _as_dtensor(local, like_mesh, place, shape):
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local.contiguous(), like_mesh, place,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def embed_rows(table, ids):
    """``table[ids]``.  On a DTensor table each rank looks its ids up in
    its own block: a vocab-sharded table gives zeros for ids outside its
    rows and the blocks are summed over the vocab's mesh dims; a
    feature-sharded one gives its feature block."""
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    ids = _replicated_as(ids, table)
    size, off = local_block(table.shape, mesh, table.placements)
    t = table.to_local(grad_placements=_grad_place(table, ids))
    i = ids.to_local()
    place, final = [], []
    for tp, ip in zip(table.placements, ids.placements):
        if isinstance(tp, Shard) and tp.dim == 0:
            place.append(Partial())
            final.append(Replicate())
        elif isinstance(tp, Shard):
            place.append(Shard(ids.ndim))
            final.append(Shard(ids.ndim))
        else:
            place.append(ip)
            final.append(ip)
    if any(p.is_partial() for p in place):
        rel = i.long() - off[0]
        mine = (rel >= 0) & (rel < size[0])
        rows = torch.nn.functional.embedding(rel.clamp(0, size[0] - 1), t)
        rows = _SumOver.apply(rows * mine[..., None].to(rows.dtype), mesh,
                              place)
    else:
        rows = torch.nn.functional.embedding(i.long(), t)
    return _as_dtensor(rows, mesh, final, (*ids.shape, table.shape[1]))


def _mesh_place(mesh, heads, dims):
    """(batch dim, head dim) → placements: batch over the data axes, heads
    over model where ``heads`` divides."""
    if dims is None:
        return None
    b, h = dims
    out = []
    for name, n in zip(mesh.mesh_dim_names, mesh.mesh.shape):
        if name in ("pod", "data") and b is not None:
            out.append(Shard(b))
        elif name == "model" and h is not None and heads % n == 0:
            out.append(Shard(h))
        else:
            out.append(Replicate())
    return out


def per_rank(fn, args, arg_dims, out_dims):
    """``fn(*args)`` on every rank's block.  ``arg_dims`` gives, per
    argument, its (batch dim, head dim) or None (not a tensor);
    ``out_dims`` the same per result.  The batch dim goes over the data
    axes, the head dim over model where the head count (the first
    argument's head dim) divides, else whole; DTensor arguments are
    redistributed so, ``fn`` runs on the local blocks, and the results
    come back as DTensors.  Without DTensor arguments, ``fn(*args)``."""
    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    first = next(a for a in args if isinstance(a, DTensor))
    mesh = first.device_mesh
    batch, heads = (first.shape[d] for d in arg_dims[0])
    main = first.redistribute(mesh, _mesh_place(mesh, heads, arg_dims[0]))
    local = []
    for a, d in zip(args, arg_dims):
        if d is None or a is None:
            local.append(a)
            continue
        a = _replicated_as(a, first).redistribute(
            mesh, _mesh_place(mesh, heads, d))
        local.append(a.to_local(grad_placements=_grad_place(a, main)))
    outs = fn(*local)
    res = []
    for o, d in zip(outs, out_dims):
        place = _mesh_place(mesh, heads, d)
        shape = list(o.shape)
        shape[d[0]] = batch
        if any(isinstance(p, Shard) and p.dim == d[1] for p in place):
            shape[d[1]] = heads
        res.append(_as_dtensor(o, mesh, place, shape))
    return tuple(res)



def pad_seq(x, n: int):
    """(B, S, D) → (B, n + S, D) with n zero rows first, on each rank's
    own (batch, feature) block of a DTensor."""
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, n, 0))
    return per_rank(lambda t: (pad(t),), (x,), ((0, 2),), ((0, 2),))[0]
