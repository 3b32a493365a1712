"""Hymba-style hybrid layer: attention heads and a mamba SSM branch run in
PARALLEL on the same normed input, their outputs fused by learned
per-branch gains.  The stack is heterogeneous: the first ``L - n_global``
layers use sliding-window attention (a ring-buffer KV cache at decode),
the last ``n_global_layers`` attend globally (a full KV cache).

The layer pins its q/k/v shardings with ``sharding_ctx``'s
``constrain_*`` where the reference does (the identity without a mesh),
and writes its decode caches through ``write_at`` / ``assign``, which on
a DTensor cache write each rank's shard.  Parameters are dicts of stacked
``(L, …)`` tensors and the layers run in a Python loop; with ``remat``
each layer runs under ``torch.utils.checkpoint`` (non-reentrant), as the
reference wraps it in ``jax.checkpoint``: its activations are recomputed
in the backward.
"""
from __future__ import annotations

import functools

import torch

from .common import (apply_norm, apply_rope, gated_mlp, layer_params,
                     rope_tables, run_layers)
from .sharding_ctx import (assign, constrain_attn_q, constrain_heads,
                           merge_heads, split_heads, write_at)
from .ssm import mamba_branch, mamba_defs
from .transformer import chunked_attention, decode_attn


def _branch_defs(cfg, L: int) -> dict:
    D = cfg.d_model
    sub = cfg.replace(n_layers=L)
    defs = {
        "ln1": {"w": ((L, D), "rep")},
        "ln2": {"w": ((L, D), "rep")},
        "wq": ((L, D, cfg.q_dim), "col"),
        "wk": ((L, D, cfg.kv_dim), "col"),
        "wv": ((L, D, cfg.kv_dim), "col"),
        "wo": ((L, cfg.q_dim, D), "row"),
        "attn_gain": ((L, D), "rep"),
        "ssm_gain": ((L, D), "rep"),
        "wg": ((L, D, cfg.d_ff), "col"),
        "wu": ((L, D, cfg.d_ff), "col"),
        "wd": ((L, cfg.d_ff, D), "row"),
    }
    defs.update(mamba_defs(sub))
    return defs


def hybrid_model_defs(cfg) -> dict:
    n_swa = cfg.n_layers - cfg.n_global_layers
    return {
        "embed": ((cfg.vocab_padded, cfg.d_model), "embed"),
        "final_norm": {"w": ((cfg.d_model,), "rep")},
        "layers": _branch_defs(cfg, n_swa),        # sliding-window stack
        "glayers": _branch_defs(cfg, cfg.n_global_layers),
    }


def hybrid_layer(x, lp, cfg, *, cos, sin, rot, window, cache=None,
                 pos=None, write=None, chunk=1024):
    """window=0 → global layer.  cache=(k, v, conv, ssm) → decode (S=1):
    this layer's K/V cache slices are written in place at ``write`` (a
    0-d device tensor, as ``pos``) and ``(x, (new_conv, new_ssm))`` is
    returned; else ``(x, None)``."""
    h = apply_norm(x, lp["ln1"], cfg.norm)
    q = constrain_attn_q(split_heads(h @ lp["wq"], cfg.n_heads, cfg.head_dim))
    k = constrain_heads(split_heads(h @ lp["wk"], cfg.n_kv, cfg.head_dim))
    v = constrain_heads(split_heads(h @ lp["wv"], cfg.n_kv, cfg.head_dim))
    q = apply_rope(q, cos, sin, rot)
    k = apply_rope(k, cos, sin, rot)
    new_state = None
    if cache is not None:
        ck, cv, conv_s, ssm_s = cache
        at = write.reshape(1)
        write_at(ck, 1, at, k)
        write_at(cv, 1, at, v)
        attn = decode_attn(q, ck, cv, pos.clamp(max=ck.shape[1] - 1))
    else:
        attn = chunked_attention(q, k, v, window=window, chunk=chunk)
    # heads (or, context-parallel, the query sequence) back to batch-only
    # before the merge into features, as the dense layer pins it
    attn = merge_heads(constrain_heads(attn)) @ lp["wo"]

    if cache is not None:
        ssm, new_conv, new_ssm = mamba_branch(h, lp, cfg, conv_state=conv_s,
                                              ssm_state=ssm_s)
        new_state = (new_conv, new_ssm)
    else:
        ssm = mamba_branch(h, lp, cfg)

    x = x + attn * lp["attn_gain"] + ssm * lp["ssm_gain"]
    h2 = apply_norm(x, lp["ln2"], cfg.norm)
    return x + gated_mlp(h2, lp["wg"], lp["wu"], lp["wd"], cfg.act), new_state


def _layer_out(x, lp, cfg, **kw):
    return hybrid_layer(x, lp, cfg, **kw)[0]


def _run_stack(x, stack, cfg, *, cos, sin, rot, window, chunk, remat):
    blk = functools.partial(_layer_out, cfg=cfg, cos=cos, sin=sin, rot=rot,
                            window=window, chunk=chunk)
    return run_layers(blk, x, stack, remat)


def hybrid_forward(params, cfg, embeds, *, remat=True, chunk=1024):
    S = embeds.shape[1]
    positions = torch.arange(S, device=embeds.device)[None, :]
    cos, sin, rot = rope_tables(positions, cfg.head_dim, cfg.rope_fraction,
                                cfg.rope_base)
    x = _run_stack(embeds, params["layers"], cfg, cos=cos, sin=sin, rot=rot,
                   window=cfg.sliding_window, chunk=chunk, remat=remat)
    x = _run_stack(x, params["glayers"], cfg, cos=cos, sin=sin, rot=rot,
                   window=0, chunk=chunk, remat=remat)
    return apply_norm(x, params["final_norm"], cfg.norm)


def hybrid_decode_step(params, cfg, token_embed, cache, pos):
    """cache: SWA ring stacks ("k", "v" (Lswa, B, W, KV, hd), "conv",
    "ssm") + global stacks ("gk", "gv" (Lg, B, S, KV, hd), "gconv",
    "gssm").  Updated in place (JAX returns a new cache; here the old
    one is not kept, which saves a copy of every stack per token) and
    returned.  ``pos`` is a 0-d int64 tensor on the cache's device, and
    nothing here reads it on the host, so the step can be captured as a
    CUDA graph and replayed with ``pos`` refilled."""
    positions = pos.reshape(1, 1)
    cos, sin, rot = rope_tables(positions, cfg.head_dim, cfg.rope_fraction,
                                cfg.rope_base)
    x = token_embed
    for stack, (kk, vk, ck, sk), ring in (
            (params["layers"], ("k", "v", "conv", "ssm"), True),
            (params["glayers"], ("gk", "gv", "gconv", "gssm"), False)):
        for i in range(stack["wq"].shape[0]):
            kc, vc = cache[kk][i], cache[vk][i]
            write = pos % kc.shape[1] if ring else pos
            x, (conv, ssm) = hybrid_layer(
                x, layer_params(stack, i), cfg, cos=cos, sin=sin, rot=rot,
                window=0, cache=(kc, vc, cache[ck][i], cache[sk][i]),
                pos=pos, write=write)
            assign(cache[ck][i], conv)
            assign(cache[sk][i], ssm)
    x = apply_norm(x, params["final_norm"], cfg.norm)
    return x, cache
