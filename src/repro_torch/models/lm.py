"""LM entry points of the port, for the families it runs (so far the
hybrid family, Hymba):

  * ``model_defs(cfg)``                  — dict of (shape, role) leaves;
  * ``init_params(cfg, generator=...)``  — materialised parameters;
  * ``forward_hidden(params, cfg, batch)`` → final hidden states;
  * ``train_loss(params, cfg, batch)``   → mean next-token CE;
  * ``prefill(params, cfg, batch)``      → last-token logits;
  * ``decode_step(params, cfg, token, cache, pos)`` → (logits, cache);
  * ``cache_specs(cfg, cell)`` / ``init_cache(cfg, cell)`` /
    ``input_specs(cfg, cell)``.

Parameters are a nested dict of tensors with stacked ``(L, …)`` layer
leaves, in bf16 except ``a_log`` (float32), as the JAX package keeps
them; ``convert.lm_params_to_torch`` carries the reference's over.  The
model functions follow the device of their inputs; ``init_params`` uses
``resolve_device`` (CUDA unless told otherwise).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from .hybrid import hybrid_decode_step, hybrid_forward, hybrid_model_defs
from .transformer import chunked_xent, logits_for

DTYPE = torch.bfloat16


def _check_family(cfg):
    """The port runs the hybrid family; the JAX package's dense, MoE,
    RWKV, Whisper and LLaVA families are still to port."""
    if cfg.family != "hybrid":
        raise NotImplementedError(f"family {cfg.family!r} is not ported "
                                  "yet (ROADMAP Queue 1 item 11)")


# ------------------------------------------------------------- param defs
def model_defs(cfg) -> dict:
    _check_family(cfg)
    return hybrid_model_defs(cfg)


def _is_shape_leaf(x):
    return (isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)
            and isinstance(x[1], str))


def map_defs(fn, defs, path=()):
    """Apply ``fn(path, (shape, role))`` to every leaf of a defs tree, in
    sorted key order; returns the same nesting of dicts."""
    if _is_shape_leaf(defs):
        return fn(path, defs)
    return {k: map_defs(fn, defs[k], path + (k,)) for k in sorted(defs)}


def init_params(cfg, *, generator: torch.Generator, device=None,
                dtype=DTYPE):
    """Materialise parameters on ``device`` by the reference's rules: norm
    weights and gains ones, ``a_log`` float32 ``log(1..N)``, biases zero
    (every name starting with ``b``, ``bc_w`` included), ``mu`` 0.5,
    ``w_bias`` −1, other matrices N(0, 0.02) drawn on ``generator``'s
    device (so they differ from the JAX package's for the same seed)."""
    device = resolve_device(device)
    return map_defs(lambda path, d: _init_one(
        generator, "/".join(path), d[0], dtype).to(device), model_defs(cfg))


def _init_one(generator, name, shape, dtype):
    dev = generator.device
    last = name.split("/")[-1]
    if last in ("w",) or "gain" in last:          # norm scales / gains
        return torch.ones(shape, dtype=dtype, device=dev)
    if last == "a_log":                            # mamba A init
        n = shape[-1]
        base = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                      device=dev))
        return base.expand(shape).contiguous()
    if last in ("b", "mu", "cm_mu", "w_bias", "u_bonus", "d_skip",
                "dt_b") or last.startswith("b"):
        if last in ("mu", "cm_mu"):
            return torch.full(shape, 0.5, dtype=dtype, device=dev)
        if last == "w_bias":
            return torch.full(shape, -1.0, dtype=dtype, device=dev)
        return torch.zeros(shape, dtype=dtype, device=dev)
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=dev)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------- forward
def _embed_tokens(params, cfg, tokens):
    return params["embed"][tokens].to(DTYPE)


def forward_hidden(params, cfg, batch, *, remat=True, chunk=1024):
    """→ final hidden states (B, S, D) of ``batch["tokens"]`` (B, S);
    ``remat`` recomputes each layer's activations in the backward."""
    _check_family(cfg)
    x = _embed_tokens(params, cfg, batch["tokens"])
    return hybrid_forward(params, cfg, x, remat=remat, chunk=chunk)


def train_loss(params, cfg, batch, *, remat=True, chunk=1024):
    """Mean next-token CE of ``batch["tokens"]`` against
    ``batch["labels"]`` (B, S), float32; ``chunk`` is the attention's
    query chunk (the loss keeps ``chunked_xent``'s own, as the reference
    does)."""
    h = forward_hidden(params, cfg, batch, remat=remat, chunk=chunk)
    return chunked_xent(h, params["embed"], batch["labels"],
                        logit_softcap=cfg.logit_softcap,
                        lm_head=params.get("lm_head"),
                        valid_vocab=(cfg.vocab if cfg.vocab_padded
                                     > cfg.vocab else None))


# ---------------------------------------------------------------- serving
def prefill(params, cfg, batch, *, chunk=1024):
    """Run the full prompt, return the last token's logits (B, 1, Vp)."""
    h = forward_hidden(params, cfg, batch, remat=False, chunk=chunk)
    return logits_for(h[:, -1:], params, cfg)


def decode_step(params, cfg, token, cache, pos):
    """One serve step: (B, 1) token + cache → (B, 1, Vp) logits + cache
    (updated in place).  ``pos`` is an int or a 0-d integer tensor on the
    token's device; as a tensor nothing reads it on the host, so the step
    can be captured as a CUDA graph (``launch/serve.py::generate``)."""
    _check_family(cfg)
    x = _embed_tokens(params, cfg, token)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=token.device)
    h, cache = hybrid_decode_step(params, cfg, x, cache, pos)
    return logits_for(h, params, cfg), cache


# ------------------------------------------------------------------ specs
def cache_specs(cfg, cell, dtype=DTYPE) -> dict:
    """name → (shape, dtype) of every decode cache tensor for ``cell``."""
    _check_family(cfg)
    B, S = cell.global_batch, cell.seq_len
    L, KV, hd = cfg.n_layers, cfg.n_kv, cfg.head_dim
    Lswa = L - cfg.n_global_layers
    Lg = cfg.n_global_layers
    W = min(cfg.sliding_window, S)
    Di = cfg.ssm_expand * cfg.d_model
    N = cfg.ssm_state
    return {
        "k": ((Lswa, B, W, KV, hd), dtype),
        "v": ((Lswa, B, W, KV, hd), dtype),
        "conv": ((Lswa, B, 3, Di), dtype),
        "ssm": ((Lswa, B, Di, N), torch.float32),
        "gk": ((Lg, B, S, KV, hd), dtype),
        "gv": ((Lg, B, S, KV, hd), dtype),
        "gconv": ((Lg, B, 3, Di), dtype),
        "gssm": ((Lg, B, Di, N), torch.float32),
    }


def init_cache(cfg, cell, dtype=DTYPE, device=None) -> dict:
    """Zeroed decode cache on ``device`` (CUDA unless told otherwise)."""
    device = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in cache_specs(cfg, cell, dtype).items()}


def input_specs(cfg, cell) -> dict:
    """name → (shape, dtype) of every model input of ``cell``: the token
    of a decode step, else tokens and labels."""
    _check_family(cfg)
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "decode":
        return {"token": ((B, 1), torch.int32)}
    return {"tokens": ((B, S), torch.int32),
            "labels": ((B, S), torch.int32)}
