"""Shared transformer building blocks of the LM side (bf16 activations
with float32 islands, as the JAX package computes them), and the
next-token loss.

Not ported: the JAX package's cost mode and ``scan_layers`` (the port
loops over layers in Python, ``layer_params`` giving each layer's views)
and its perf-option registry: ``transformer.moe_ffn`` is the default
MoE dispatch, and the other options have no counterpart here
(``ssm_backend``: the device picks the scan kernel or its plain version,
see ``models/ssm.py``).  ``gqa_attention`` has no caller in the JAX
package's models (its transformer imports it and attends through
``_attn_block``), so it is not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -2.0e38          # f32-safe mask value


def rms_norm(x, w, eps=1e-6, plus_one=False):
    """RMSNorm computed in float32, cast back to ``x``'s dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if plus_one else w.float()
    return (y * scale).to(x.dtype)


def layer_norm(x, w, b, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def apply_norm(x, p, kind="rmsnorm", plus_one=False):
    if kind == "layernorm":
        return layer_norm(x, p["w"], p["b"])
    return rms_norm(x, p["w"], plus_one=plus_one)


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap)


def layer_params(stack: dict, i: int) -> dict:
    """Layer ``i``'s parameters: a view of each stacked ``(L, …)`` leaf."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stack.items()}


def run_layers(blk, x, stack: dict, remat: bool, *args):
    """``x = blk(x, layer_params(stack, i), *args)`` for each layer of the
    stacked leaves, in order; with ``remat`` each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant), as the reference wraps its
    layer body in ``jax.checkpoint``."""
    leaf = stack
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    for i in range(leaf.shape[0]):
        lp = layer_params(stack, i)
        x = (checkpoint(blk, x, lp, *args, use_reentrant=False) if remat
             else blk(x, lp, *args))
    return x


# -------------------------------------------------------------------- RoPE
def rope_tables(positions, head_dim: int, fraction: float = 1.0,
                base: float = 10000.0):
    """cos/sin tables (..., rot/2) for neox-style rotate-half RoPE, in
    float32.  ``fraction < 1`` = partial rotary."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    inv = 1.0 / (base ** exps)
    ang = positions.float()[..., None] * inv                 # (..., rot/2)
    return torch.cos(ang), torch.sin(ang), rot


def apply_rope(x, cos, sin, rot: int):
    """x (B, S, H, hd); cos/sin (B?, S, rot/2) broadcast over heads, cast
    to the activation dtype first."""
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    c = cos[..., None, :].to(x.dtype)        # (B, S, 1, rot/2)
    s = sin[..., None, :].to(x.dtype)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([out, xp], dim=-1)


# --------------------------------------------------------------------- MLP
def gelu_tanh(x):
    """``jax.nn.gelu``'s default (the tanh approximation) as it computes
    it: op by op in the activation dtype, its constants rounded to that
    dtype (bit for bit the reference's on the CPU in bf16).
    ``F.gelu(approximate="tanh")`` rounds once from float32 and differs
    by an ulp in ~43% of bf16 elements, which shows through gemma2's
    36,864-wide MLP.  The constants are Python floats, so the function can
    be captured in a CUDA graph."""
    rnd = lambda v: float(torch.tensor(v).to(x.dtype))
    c, a = rnd(math.sqrt(2 / math.pi)), rnd(0.044715)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * x ** 3))))


def activation(act: str):
    """The gated MLP's activation: SiLU or the tanh-approximate GELU."""
    return F.silu if act == "silu" else gelu_tanh


def gated_mlp(x, wg, wu, wd, act="silu"):
    a = activation(act)
    return (a(x @ wg) * (x @ wu)) @ wd


def plain_mlp(x, w1, b1, w2, b2):
    """Whisper's MLP: ``gelu_tanh(x·w1 + b1)·w2 + b2`` (``jax.nn.gelu``'s
    default form, as the reference computes it)."""
    return gelu_tanh(x @ w1 + b1) @ w2 + b2


# -------------------------------------------------------------------- loss
def softmax_xent(logits, labels, mask=None):
    """Mean next-token CE.  logits (B, S, V) any dtype → float32
    reduction; ``mask`` (B, S) weights the tokens."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()
