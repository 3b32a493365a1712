"""LM entry points of the port, for every family of the JAX package:
hybrid (Hymba), dense (qwen2, qwen1.5, chatglm3, gemma2), MoE (granite),
VLM (llava, the dense backbone behind a prefix of patch embeddings), SSM
(RWKV6) and encoder-decoder (Whisper, on stub frame embeddings):

  * ``model_defs(cfg)``                  — dict of (shape, role) leaves;
  * ``param_specs(cfg)``                 — (shape, dtype) leaves (dry run);
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
decode caches are bf16 but for the float32 SSM states (Hymba's ``ssm``,
RWKV's ``wkv``).  The model functions follow the device of their inputs;
``init_params`` uses ``resolve_device`` (CUDA unless told otherwise).
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from .common import apply_norm, layer_params, run_layers
from .hybrid import hybrid_decode_step, hybrid_forward, hybrid_model_defs
from .sharding_ctx import assign, embed_rows
from .ssm import RWKV_HEAD_DIM, rwkv_defs, rwkv_layer
from .transformer import (chunked_xent, dense_decode_step, dense_forward,
                          dense_model_defs, logits_for)
from .whisper import (whisper_decode_step, whisper_decode_train,
                      whisper_encode, whisper_model_defs)

DTYPE = torch.bfloat16
INIT_PIECE = 1 << 30     # elements of a leaf's float32 draw at a time
DENSE = ("dense", "moe", "vlm")        # one model function in the reference
FAMILIES = DENSE + ("hybrid", "ssm", "encdec")


def _check_family(cfg):
    """A family neither package has raises the reference's error."""
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


# ------------------------------------------------------------- param defs
def model_defs(cfg) -> dict:
    _check_family(cfg)
    if cfg.family == "hybrid":
        return hybrid_model_defs(cfg)
    if cfg.family == "ssm":
        D = cfg.d_model
        return {
            "embed": ((cfg.vocab_padded, D), "embed"),
            "ln0": {"w": ((D,), "rep"), "b": ((D,), "rep")},
            "final_norm": {"w": ((D,), "rep"), "b": ((D,), "rep")},
            "layers": rwkv_defs(cfg),
        }
    if cfg.family == "encdec":
        return whisper_model_defs(cfg)
    return dense_model_defs(cfg)


def _is_shape_leaf(x):
    return (isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)
            and isinstance(x[1], str))


def map_defs(fn, defs, path=()):
    """Apply ``fn(path, (shape, role))`` to every leaf of a defs tree, in
    sorted key order; returns the same nesting of dicts."""
    if _is_shape_leaf(defs):
        return fn(path, defs)
    return {k: map_defs(fn, defs[k], path + (k,)) for k in sorted(defs)}


def param_specs(cfg, dtype=DTYPE) -> dict:
    """(shape, dtype) of every parameter, as the reference's
    ``param_specs``: every leaf in ``dtype`` (the dry run's arguments;
    ``init_params`` keeps ``a_log`` in float32)."""
    return map_defs(lambda _, d: (d[0], dtype), model_defs(cfg))


def init_params(cfg, *, generator: torch.Generator, device=None,
                dtype=DTYPE):
    """Materialise parameters on ``device`` by the reference's rules: norm
    weights and gains ones, ``a_log`` float32 ``log(1..N)``, biases zero
    (every name starting with ``b``, ``bc_w`` included, but not Whisper's
    cross-attention ``xb*``), ``u_bonus`` zero, ``mu`` and ``cm_mu`` 0.5,
    ``w_bias`` −1, other leaves N(0, 0.02) drawn on ``generator``'s
    device (so they differ from the JAX package's for the same seed).
    A leaf of more than ``INIT_PIECE`` elements is drawn in pieces along
    its first axis, so the float32 draw never holds more than that:
    gemma2-27b's full config initialises on one 80 GB card.  Smaller
    leaves (all of Hymba's) are drawn whole, as before."""
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
    out = torch.empty(shape, dtype=dtype, device=dev)
    n = math.prod(shape)
    for part in ((out,) if n <= INIT_PIECE
                 else out.split(max(1, INIT_PIECE * shape[0] // n))):
        w = torch.randn(part.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        part.copy_(w.mul_(0.02))                 # rounds as ``.to(dtype)``
    return out


# ---------------------------------------------------------------- forward
def _embed_tokens(params, cfg, tokens):
    """Embedding rows in bf16; gemma's ``embed_scale`` multiplies them by
    sqrt(float32(d_model)) rounded to bf16 first, as the reference does
    (68.0 for d_model 4608, not 67.88)."""
    x = embed_rows(params["embed"], tokens).to(DTYPE)
    if cfg.embed_scale:       # a Python float: no copy to the device
        x = x * float(torch.tensor(float(cfg.d_model)).sqrt().to(DTYPE))
    return x


def _rwkv_forward(params, embeds, remat=True):
    """RWKV6: ``ln0`` after the embedding, the layers, ``final_norm``."""
    x = apply_norm(embeds, params["ln0"], "layernorm")
    x = run_layers(lambda a, lp: rwkv_layer(a, lp)[0], x, params["layers"],
                   remat)
    return apply_norm(x, params["final_norm"], "layernorm")


def forward_hidden(params, cfg, batch, *, remat=True, chunk=1024):
    """→ final hidden states (B, S, D) of ``batch["tokens"]`` (B, S);
    ``remat`` recomputes each layer's activations in the backward.  A VLM
    batch's ``patches`` (B, P, D) go first, cast to bf16, and their rows
    are dropped from the output.  An encoder-decoder batch's ``frames``
    (B, Sa, D), cast to bf16, go through the encoder, and the tokens
    through the decoder against its states."""
    _check_family(cfg)
    if cfg.family == "encdec":
        enc = whisper_encode(params, cfg, batch["frames"].to(DTYPE),
                             remat=remat, chunk=chunk)
        return whisper_decode_train(params, cfg, batch["tokens"], enc,
                                    remat=remat, chunk=chunk)
    x = _embed_tokens(params, cfg, batch["tokens"])
    if cfg.family == "hybrid":
        return hybrid_forward(params, cfg, x, remat=remat, chunk=chunk)
    if cfg.family == "ssm":
        return _rwkv_forward(params, x, remat=remat)
    if cfg.family == "vlm" and cfg.n_patches and "patches" in batch:
        P = batch["patches"].shape[1]
        x = torch.cat([batch["patches"].to(DTYPE), x], dim=1)
        return dense_forward(params, cfg, x, remat=remat, chunk=chunk)[:, P:]
    return dense_forward(params, cfg, x, remat=remat, chunk=chunk)


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
    can be captured as a CUDA graph (``launch/serve.py::generate``).
    RWKV's step ignores it; Whisper embeds its own token, with
    ``pos_dec[pos]``."""
    _check_family(cfg)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=token.device)
    if cfg.family == "encdec":
        h, cache = whisper_decode_step(params, cfg, token, cache, pos)
    else:
        step = {"hybrid": hybrid_decode_step,
                "ssm": _rwkv_decode_step}.get(cfg.family, dense_decode_step)
        h, cache = step(params, cfg, _embed_tokens(params, cfg, token),
                        cache, pos)
    return logits_for(h, params, cfg), cache


def _rwkv_decode_step(params, cfg, x, cache, pos):
    """RWKV6's step (``pos`` unused): ``ln0``, each layer from its states
    ``last1``, ``wkv`` and ``last2``, which are overwritten in place with
    the new ones, ``final_norm``; returns (hidden state, cache)."""
    x = apply_norm(x, params["ln0"], "layernorm")
    stack = params["layers"]
    for i in range(stack["wr"].shape[0]):
        states = tuple(cache[k][i] for k in ("last1", "wkv", "last2"))
        x, new = rwkv_layer(x, layer_params(stack, i), states=states)
        for old, t in zip(states, new):
            assign(old, t)
    return apply_norm(x, params["final_norm"], "layernorm"), cache


# ------------------------------------------------------------------ specs
def cache_specs(cfg, cell, dtype=DTYPE) -> dict:
    """name → (shape, dtype) of every decode cache tensor for ``cell``."""
    _check_family(cfg)
    B, S = cell.global_batch, cell.seq_len
    L, KV, hd = cfg.n_layers, cfg.n_kv, cfg.head_dim
    if cfg.family in DENSE:
        return {"k": ((L, B, S, KV, hd), dtype),
                "v": ((L, B, S, KV, hd), dtype)}
    if cfg.family == "ssm":
        H = cfg.d_model // RWKV_HEAD_DIM
        return {
            "last1": ((L, B, 1, cfg.d_model), dtype),
            "wkv": ((L, B, H, RWKV_HEAD_DIM, RWKV_HEAD_DIM), torch.float32),
            "last2": ((L, B, 1, cfg.d_model), dtype),
        }
    if cfg.family == "encdec":
        return {k: ((L, B, S, KV, hd), dtype) for k in ("k", "v", "xk", "xv")}
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
    of a decode step, else tokens and labels, and a VLM's patch
    embeddings, which take ``n_patches`` of the S positions; an
    encoder-decoder cell has S frames and max(128, S // 4) tokens."""
    _check_family(cfg)
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "decode":
        return {"token": ((B, 1), torch.int32)}
    if cfg.family == "encdec":
        St = max(128, S // 4)
        return {"frames": ((B, S, cfg.d_model), DTYPE),
                "tokens": ((B, St), torch.int32),
                "labels": ((B, St), torch.int32)}
    if cfg.family == "vlm":
        P = cfg.n_patches
        return {"patches": ((B, P, cfg.d_model), DTYPE),
                "tokens": ((B, S - P), torch.int32),
                "labels": ((B, S - P), torch.int32)}
    return {"tokens": ((B, S), torch.int32),
            "labels": ((B, S), torch.int32)}
