"""Sharded train / prefill / decode steps of the LM mesh path (the
reference's ``repro/launch/steps.py``, its jitted steps with explicit
shardings).

The reference compiles each step with ``in_shardings`` and lets GSPMD
place the collectives.  Here each rank of a ``DeviceMesh`` runs the
step eagerly on DTensors: parameters, AdamW state, batch and caches
carry the reference's specs as placements (``launch/sharding.py``), the
model's ``constrain_*`` calls pin the layouts between, and DTensor picks
the collectives (where GSPMD picks XLA's).  Plain tensors made inside
the model (RoPE tables, masks, positions) are taken as replicated
(``implicit_replication``).

* ``sharded_train_step`` (``jit_train_step``): loss, gradient and AdamW
  with global-norm clipping; parameters and moments updated in place, as
  the reference donates them; ``zero1`` shards the moments over the data
  axis too (``_zero1_spec``).  Its state checkpoints through
  ``CheckpointManager`` and resumes on any mesh shape, or on one device,
  with ``train_state_placements`` of the new mesh.
* ``sharded_prefill_step`` (``jit_prefill_step``): the last token's
  logits.
* ``sharded_decode_step`` (``jit_decode_step``): one token, the cache
  updated in place; ``shard_cache_seq`` shards a cache's sequence where
  its heads do not divide (each rank writes the position it owns).
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models import lm, sharding_ctx
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.adamw import tree_map
from . import sharding as sh


def opt_state_specs(cfg):
    """(shape, dtype) of the AdamW state: float32 moments like the
    parameters and an int32 step."""
    f32 = lambda _, d: (d[0], torch.float32)
    return {"m": lm.map_defs(f32, lm.model_defs(cfg)),
            "v": lm.map_defs(f32, lm.model_defs(cfg)),
            "step": ((), torch.int32)}


def _zero1_spec(spec, shape, mesh) -> tuple:
    """ZeRO-1: additionally shard optimizer state over the data axis on
    the first still-unsharded, divisible dim."""
    dsize = sh.axis_sizes(mesh).get("data", 1)
    spec = list(spec) + [None] * (len(shape) - len(spec))
    for i, (s, cur) in enumerate(zip(shape, spec)):
        if cur is None and s % dsize == 0 and s >= dsize:
            spec[i] = "data"
            return tuple(spec)
    return tuple(spec)


def opt_state_placements(cfg, mesh, zero1: bool = False):
    """Placements of the AdamW state: the parameters', or with ``zero1``
    the ZeRO-1 ones; the step replicated."""
    if zero1:
        one = lambda _, d: sh.placements(
            _zero1_spec(sh.role_spec(d[1], d[0], mesh), d[0], mesh), mesh)
        ps = lm.map_defs(one, lm.model_defs(cfg))
    else:
        ps = sh.param_placements(cfg, mesh)
    return {"m": ps, "v": ps, "step": sh.replicated(mesh)}


def train_state_placements(cfg, mesh, zero1: bool = False):
    """Placements of a ``(params, opt_state)`` training state on ``mesh``:
    the tree ``CheckpointManager.restore(placements=)`` takes to resume a
    checkpoint of ``sharded_train_step``'s state on this mesh, whatever
    mesh saved it."""
    return (sh.param_placements(cfg, mesh),
            opt_state_placements(cfg, mesh, zero1))


def init_opt_state(cfg, mesh, zero1: bool = False, device=None):
    """Zero moments on ``mesh`` with ``opt_state_placements`` (each rank
    allocates its shard only) and step 0."""
    from torch.distributed.tensor import zeros
    place = opt_state_placements(cfg, mesh, zero1)

    def z(path, d):
        p = place["m"]
        for k in path:
            p = p[k]
        return zeros(d[0], dtype=torch.float32, device_mesh=mesh,
                     placements=p)

    return {"m": lm.map_defs(z, lm.model_defs(cfg)),
            "v": lm.map_defs(z, lm.model_defs(cfg)), "step": 0}


@contextmanager
def on_mesh(mesh):
    """The model's constraints pinned to ``mesh``, plain tensors taken as
    replicated, for the duration."""
    prev = sharding_ctx.get_mesh()
    sharding_ctx.set_mesh(mesh)
    try:
        with implicit_replication():
            yield
    finally:
        sharding_ctx.set_mesh(prev)


def _constrain_batch(batch, mesh):
    bd = sh.data_axes(mesh)
    return {k: sharding_ctx.constrain(v, (bd,) + (None,) * (v.ndim - 1))
            if isinstance(v, DTensor) and v.ndim >= 1 else v
            for k, v in batch.items()}


def sharded_train_step(cfg, mesh, opt_cfg=None, *, chunk=1024):
    """The reference's ``jit_train_step`` (its ``make_train_fn`` inlined):
    ``step(params, opt_state, batch) → (params, opt_state, loss)`` with
    the parameters on ``sh.param_placements``, the state from
    ``init_opt_state(cfg, mesh, zero1)`` (its placements are the ZeRO-1
    choice) and the batch on ``sh.batch_placements(lm.input_specs(cfg,
    cell), mesh)``.  The parameters and the state are updated in place
    and returned; ``loss`` is a 0-d DTensor (replicated).  AdamW at lr
    1e-4 with global-norm clipping at 1.0 unless ``opt_cfg`` says
    otherwise."""
    opt_cfg = opt_cfg or AdamWConfig(lr=1e-4, grad_clip=1.0)

    def train_step(params, opt_state, batch):
        with on_mesh(mesh):
            p = tree_map(lambda t: t.detach().requires_grad_(), params)
            loss = lm.train_loss(p, cfg, _constrain_batch(batch, mesh),
                                 chunk=chunk)
            loss.backward()
            grads = tree_map(lambda t: t.grad, p)
            del p
            params, opt_state = adamw_update(params, grads, opt_state,
                                             opt_cfg, inplace=True)
        return params, opt_state, loss.detach()

    return train_step


def sharded_prefill_step(cfg, mesh, *, chunk=1024):
    """The reference's ``jit_prefill_step``: ``step(params, batch)`` →
    the last token's logits (a DTensor)."""
    def step(params, batch):
        with on_mesh(mesh), torch.no_grad():
            return lm.prefill(params, cfg, _constrain_batch(batch, mesh),
                              chunk=chunk)

    return step


def sharded_decode_step(cfg, mesh):
    """The reference's ``jit_decode_step``: ``step(params, token, cache,
    pos)`` → (logits, cache), the cache updated in place (its placements,
    ``sh.cache_placements(..., shard_seq=)``, are the ``shard_cache_seq``
    choice); ``pos`` an int or a 0-d integer tensor."""
    def step(params, token, cache, pos):
        with on_mesh(mesh), torch.no_grad():
            return lm.decode_step(params, cfg, token, cache, pos)

    return step
