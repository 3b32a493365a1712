"""Shared transformer building blocks of the LM side (bf16 activations
with float32 islands, as the JAX package computes them), the next-token
loss, and the perf-option registry.

The perf options (``PERF_DEFAULTS``, ``set_perf_options``) carry the
reference's keys, defaults and values; a key or value the reference does
not have raises (``set_perf_options``).  ``ssm_scan_dtype="bfloat16"``
rounds the scan's operands in bf16 and scans them in float32, as the
reference's Pallas route does (``models/ssm.py``).  ``ssm_backend``
keeps the port's deviation: the device picks the scan kernel or its
plain version (``models/ssm.py``), so it takes only its default,
``"xla"``, and ``"pallas"`` raises.  The cost mode
(``set_cost_mode``) is on while ``launch/dryrun.py`` counts a step; the
port loops over layers in Python (``layer_params`` gives each layer's
views), so it has no scan to unroll, and the mode only routes the
selective scan through its custom op, whose kernel bytes the counter
prices (``kernels/selective_scan/ops.py``).  ``gqa_attention`` has no
caller in the JAX package's models (its transformer imports it and
attends through ``_attn_block``), so it is not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

NEG_INF = -2.0e38          # f32-safe mask value

_COST_MODE = [False]


def set_cost_mode(on: bool):
    _COST_MODE[0] = bool(on)


def cost_mode() -> bool:
    return _COST_MODE[0]


# The reference's perf options, with its keys and defaults; each value the
# port honours is listed, and ``set_perf_options`` raises on any other.
PERF_DEFAULTS = {
    "moe_dispatch": "global",      # global cumsum | "batched" | "shard_map"
    "ssm_scan_dtype": "float32",   # dtype of the scan operands A, dA, dBx
    "remat_policy": "full",        # full recompute | "dots" | "dots_nb"
    "seq_parallel": False,         # Megatron SP residual activations
    "bf16_norm_grad": False,       # bf16 dx cotangent through RMSNorm
    "ssm_backend": "xla",          # the device picks the scan either way
}
PERF_VALUES = {
    "moe_dispatch": ("global", "batched", "shard_map"),
    "ssm_scan_dtype": ("float32", "bfloat16"),
    "remat_policy": ("full", "dots", "dots_nb"),
    "seq_parallel": (False, True),
    "bf16_norm_grad": (False, True),
    "ssm_backend": ("xla",),
}
_PERF = dict(PERF_DEFAULTS)


def set_perf_options(**kw):
    """Set perf options (``None`` leaves one as it is).  An unknown key
    raises ``KeyError``; a value the reference does not have raises
    ``NotImplementedError``, and so does ``ssm_backend="pallas"``: the
    device picks the scan."""
    for k, v in kw.items():
        if v is None:
            continue
        if k not in PERF_VALUES:
            raise KeyError(f"unknown perf option {k!r}; known: "
                           f"{sorted(PERF_VALUES)}")
        if k == "ssm_backend" and v != "xla":
            raise NotImplementedError(
                f"ssm_backend={v!r}: the port has no backend choice; the "
                "tensor's device picks the scan (the CUDA kernel on the "
                "card, its plain version on the CPU)")
        if v not in PERF_VALUES[k]:
            raise NotImplementedError(
                f"perf option {k}={v!r} is not ported; the port takes "
                f"{PERF_VALUES[k]}")
    for k, v in kw.items():
        if v is not None:
            _PERF[k] = v


def reset_perf_options():
    _PERF.update(PERF_DEFAULTS)


def perf_option(key: str):
    return _PERF[key]


def rms_norm(x, w, eps=1e-6, plus_one=False):
    """RMSNorm computed in float32, cast back to ``x``'s dtype; with the
    ``bf16_norm_grad`` option on a bf16 ``x``, through ``_RMSNormBF16Grad``
    (the reference's ``_rms_norm_bf16grad``)."""
    if perf_option("bf16_norm_grad") and x.dtype == torch.bfloat16:
        return _RMSNormBF16Grad.apply(x, w, eps, plus_one)
    return _rms_norm_impl(x, w, eps, plus_one)


def _rms_norm_impl(x, w, eps=1e-6, plus_one=False):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if plus_one else w.float()
    return (y * scale).to(x.dtype)


class _RMSNormBF16Grad(torch.autograd.Function):
    """RMSNorm whose input cotangent is emitted in bf16, with the
    reference's hand-written vjp (``common.py:_rmsn_bwd``): the float32
    terms, then dx cast to x's dtype and dw to w's."""

    @staticmethod
    def forward(ctx, x, w, eps, plus_one):
        ctx.save_for_backward(x, w)
        ctx.eps, ctx.plus_one = eps, plus_one
        return _rms_norm_impl(x, w, eps, plus_one)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x32, g32 = x.float(), g.float()
        inv = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + ctx.eps)
        scale = (1.0 + w.float()) if ctx.plus_one else w.float()
        gy = g32 * scale
        dx = inv * (gy - x32 * inv * inv
                    * (gy * x32).mean(-1, keepdim=True))
        dw = (g32 * x32 * inv).sum(tuple(range(x.ndim - 1))).to(w.dtype)
        return dx.to(x.dtype), dw, None, None


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


# matmul outputs the ``dots`` / ``dots_nb`` remat policies keep (the
# reference's ``jax.checkpoint_policies.dots_saveable`` and
# ``dots_with_no_batch_dims_saveable``: a (B, S, D) @ (D, F) product has
# no batch dims, attention's batched products have)
_DOTS_NB = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_DOTS = _DOTS_NB + (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def remat_context():
    """``checkpoint``'s ``context_fn`` for the ``remat_policy`` option:
    None (recompute everything) for ``full``, else a selective-checkpoint
    context that saves the matmul outputs of the policy."""
    saved = {"dots": _DOTS, "dots_nb": _DOTS_NB}.get(
        perf_option("remat_policy"))
    if saved is None:
        return None

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return lambda: create_selective_checkpoint_contexts(policy)


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
