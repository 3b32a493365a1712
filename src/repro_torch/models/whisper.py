"""Whisper-tiny's backbone: an encoder-decoder transformer with layernorm,
learned positional embeddings, GELU MLPs and the decoder's
cross-attention.  The conv audio frontend is a stub, as in the JAX
package: the model takes precomputed frame embeddings (B, S_audio, D).

Parameters are dicts of stacked ``(L, …)`` tensors (``enc``, ``dec``) and
the layers run in a Python loop; with ``remat`` each layer runs under
``torch.utils.checkpoint`` (non-reentrant), as the reference wraps it in
``jax.checkpoint``.  Attention is ``transformer.chunked_attention`` and,
at decode, ``transformer.decode_attn`` (the reference imports the latter
from ``hybrid``; it is the same function).
"""
from __future__ import annotations

import functools

from .common import apply_norm, layer_params, plain_mlp, run_layers
from .sharding_ctx import (constrain_heads, embed_rows, merge_heads,
                           split_heads, write_at)
from .transformer import chunked_attention, decode_attn

MAX_POS = 65536          # learned positional table size (structural)


def _attn_defs(L, D, qd, kvd, prefix=""):
    return {
        f"{prefix}wq": ((L, D, qd), "col"),
        f"{prefix}wk": ((L, D, kvd), "col"),
        f"{prefix}wv": ((L, D, kvd), "col"),
        f"{prefix}wo": ((L, qd, D), "row"),
        f"{prefix}bq": ((L, qd), "col_b"),
        f"{prefix}bv": ((L, kvd), "col_b"),
        f"{prefix}bo": ((L, D), "rep"),
    }


def _ln(L, D):
    return {"w": ((L, D), "rep"), "b": ((L, D), "rep")}


def whisper_model_defs(cfg) -> dict:
    D, qd, kvd, FF = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    Le, Ld = cfg.n_enc_layers, cfg.n_layers
    enc = {"ln1": _ln(Le, D), "ln2": _ln(Le, D),
           "w1": ((Le, D, FF), "col"), "b1": ((Le, FF), "col_b"),
           "w2": ((Le, FF, D), "row"), "b2": ((Le, D), "rep")}
    enc.update(_attn_defs(Le, D, qd, kvd))
    dec = {"ln1": _ln(Ld, D), "ln2": _ln(Ld, D), "ln3": _ln(Ld, D),
           "w1": ((Ld, D, FF), "col"), "b1": ((Ld, FF), "col_b"),
           "w2": ((Ld, FF, D), "row"), "b2": ((Ld, D), "rep")}
    dec.update(_attn_defs(Ld, D, qd, kvd))
    dec.update(_attn_defs(Ld, D, qd, kvd, prefix="x"))     # cross-attn
    return {
        "embed": ((cfg.vocab_padded, D), "embed"),
        "pos_enc": ((MAX_POS, D), "rep_big"),
        "pos_dec": ((MAX_POS, D), "rep_big"),
        "enc_final": _ln(1, D),
        "dec_final": _ln(1, D),
        "enc": enc,
        "dec": dec,
    }


def _mha(h, lp, prefix, cfg, *, kv_src=None, causal, cache=None, pos=None,
         chunk=1024):
    """Self- or cross-attention with Whisper's biases (q, v and o; k has
    none).  ``cache=(ck, cv)`` (B, Smax, KV, hd) → decode self-attention:
    this token's K/V are written in place at ``pos`` (a 0-d device
    tensor) and the query attends over slots ≤ ``pos``.  Returns (out,
    the cache or None)."""
    src = h if kv_src is None else kv_src
    q = split_heads(h @ lp[f"{prefix}wq"] + lp[f"{prefix}bq"], cfg.n_heads,
                    cfg.head_dim)
    k = split_heads(src @ lp[f"{prefix}wk"], cfg.n_kv, cfg.head_dim)
    v = split_heads(src @ lp[f"{prefix}wv"] + lp[f"{prefix}bv"], cfg.n_kv,
                    cfg.head_dim)
    if cache is not None:                        # decode self-attn
        ck, cv = cache
        at = pos.reshape(1)
        write_at(ck, 1, at, k)
        write_at(cv, 1, at, v)
        out = decode_attn(q, ck, cv, pos)
    else:
        out = chunked_attention(q, k, v, causal=causal, chunk=chunk)
    out = merge_heads(constrain_heads(out))
    return out @ lp[f"{prefix}wo"] + lp[f"{prefix}bo"], cache


def _final(params, name, x):
    f = {"w": params[name]["w"][0], "b": params[name]["b"][0]}
    return apply_norm(x, f, "layernorm")


def _enc_block(a, ll, *, cfg, chunk):
    h, _ = _mha(apply_norm(a, ll["ln1"], "layernorm"), ll, "", cfg,
                causal=False, chunk=chunk)
    a = a + h
    m = plain_mlp(apply_norm(a, ll["ln2"], "layernorm"),
                  ll["w1"], ll["b1"], ll["w2"], ll["b2"])
    return a + m


def whisper_encode(params, cfg, frames, *, remat=True, chunk=1024):
    """frames (B, Sa, D) stub embeddings (in the activation dtype) →
    the encoder's final states (B, Sa, D)."""
    Sa = frames.shape[1]
    x = frames + params["pos_enc"][:Sa][None]
    blk = functools.partial(_enc_block, cfg=cfg, chunk=chunk)
    return _final(params, "enc_final",
                  run_layers(blk, x, params["enc"], remat))


def _dec_block(a, ll, enc_states, *, cfg, chunk):
    h, _ = _mha(apply_norm(a, ll["ln1"], "layernorm"), ll, "", cfg,
                causal=True, chunk=chunk)
    a = a + h
    h, _ = _mha(apply_norm(a, ll["ln2"], "layernorm"), ll, "x", cfg,
                kv_src=enc_states, causal=False, chunk=chunk)
    a = a + h
    m = plain_mlp(apply_norm(a, ll["ln3"], "layernorm"),
                  ll["w1"], ll["b1"], ll["w2"], ll["b2"])
    return a + m


def whisper_decode_train(params, cfg, tokens, enc_states, *, remat=True,
                         chunk=1024):
    """tokens (B, St) against the encoder's states → the decoder's final
    hidden states (B, St, D)."""
    St = tokens.shape[1]
    x = embed_rows(params["embed"], tokens) + params["pos_dec"][:St][None]
    blk = functools.partial(_dec_block, cfg=cfg, chunk=chunk)
    return _final(params, "dec_final",
                  run_layers(blk, x, params["dec"], remat, enc_states))


def whisper_decode_step(params, cfg, token, cache, pos):
    """One decoder token (B, 1) at ``pos`` (a 0-d int64 device tensor,
    read by indexing on the device, never on the host, so the step can
    be captured).  cache: "k", "v" (Ld, B, St, KV, hd), the self-attention
    cache, written in place at ``pos``; "xk", "xv" (Ld, B, Sa, KV, hd),
    the cross-attention K/V, every slot live (nothing in the step fills
    them, as in the reference).  Returns (the final hidden state (B, 1,
    D), cache)."""
    x = (embed_rows(params["embed"], token)
         + params["pos_dec"].index_select(0, pos.reshape(1))[None])
    stack = params["dec"]
    for i in range(stack["wq"].shape[0]):
        lp = layer_params(stack, i)
        h, _ = _mha(apply_norm(x, lp["ln1"], "layernorm"), lp, "", cfg,
                    causal=True, cache=(cache["k"][i], cache["v"][i]),
                    pos=pos)
        x = x + h
        # cross-attention against the cached encoder K/V (all slots live)
        q = split_heads(apply_norm(x, lp["ln2"], "layernorm") @ lp["xwq"]
                        + lp["xbq"], cfg.n_heads, cfg.head_dim)
        xk, xv = cache["xk"][i], cache["xv"][i]
        h = decode_attn(q, xk, xv, xk.shape[1] - 1)
        x = x + (merge_heads(constrain_heads(h)) @ lp["xwo"] + lp["xbo"])
        x = x + plain_mlp(apply_norm(x, lp["ln3"], "layernorm"),
                          lp["w1"], lp["b1"], lp["w2"], lp["b2"])
    return _final(params, "dec_final", x), cache
