"""Decoder-only transformer families: dense GQA (qwen2, qwen1.5, chatglm3,
llava's mistral backbone), gemma2 (alternating local/global attention,
softcaps, pre+post norms) and granite-style MoE; the query-chunked
attention Hymba and Whisper share; the unembedding and the
sequence-chunked loss.

Parameters are dicts of stacked ``(L, …)`` tensors and the layers run in
a Python loop; with ``remat`` each layer runs under
``torch.utils.checkpoint`` (non-reentrant), as the reference wraps it in
``jax.checkpoint``; the ``remat_policy`` perf option picks which
matmul outputs the checkpoint keeps (``common.remat_context``).  The
layers call ``sharding_ctx``'s ``constrain_*`` where the reference does:
on DTensors under a registered mesh they pin the Megatron layout, and
elsewhere they are the identity.  ``moe_ffn`` takes the reference's three
dispatches, picked by the ``moe_dispatch`` perf option: global (the
default) and batched (per-sequence queues); shard_map runs the batched
one, which on DTensors is already the reference's shard_map design (each
rank its own block, one sum over model).  On DTensors the
sequence-mixing cores (attention, the MoE dispatch) run on each rank's
local block.

Attention is plain PyTorch (``matmul`` + softmax) with the reference's
masks and casts, as the JAX package leaves it to XLA: the bf16 score
product is widened to float32, divided by √hd, soft-capped, masked with
``NEG_INF``, softmaxed in float32 and cast back to bf16 before the
product with V.  Gemma2's alternation is a static per-layer flag here
(even layers local), where the reference passes a traced one.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from .common import (NEG_INF, activation, apply_norm, apply_rope, gated_mlp,
                     layer_params, perf_option, remat_context, rope_tables,
                     softcap)
from .sharding_ctx import (constrain_attn_q, constrain_heads,
                           constrain_hidden, constrain_moe_buf,
                           _grad_place, local_block, merge_heads,
                           split_heads, write_at)


# ----------------------------------------------------------- param defs
def dense_layer_defs(cfg) -> dict:
    """(shape, role) per stacked layer tensor, as the reference's."""
    L, D = cfg.n_layers, cfg.d_model
    qd, kvd, ff = cfg.q_dim, cfg.kv_dim, cfg.d_ff
    defs = {
        "ln1": {"w": ((L, D), "rep")},
        "ln2": {"w": ((L, D), "rep")},
        "wq": ((L, D, qd), "col"),
        "wk": ((L, D, kvd), "col"),
        "wv": ((L, D, kvd), "col"),
        "wo": ((L, qd, D), "row"),
    }
    if cfg.qkv_bias:
        defs["bq"] = ((L, qd), "col_b")
        defs["bk"] = ((L, kvd), "col_b")
        defs["bv"] = ((L, kvd), "col_b")
    if cfg.n_experts:
        eff = cfg.expert_d_ff
        defs["router"] = ((L, D, cfg.n_experts), "rep")
        defs["ewg"] = ((L, cfg.n_experts, D, eff), "expert_in")
        defs["ewu"] = ((L, cfg.n_experts, D, eff), "expert_in")
        defs["ewd"] = ((L, cfg.n_experts, eff, D), "expert_down")
    else:
        defs["wg"] = ((L, D, ff), "col")
        defs["wu"] = ((L, D, ff), "col")
        defs["wd"] = ((L, ff, D), "row")
    if cfg.post_block_norm:
        defs["ln1_post"] = {"w": ((L, D), "rep")}
        defs["ln2_post"] = {"w": ((L, D), "rep")}
    if cfg.norm == "layernorm":
        for k in ("ln1", "ln2", "ln1_post", "ln2_post"):
            if k in defs:
                defs[k]["b"] = (defs[k]["w"][0], "rep")
    return defs


def dense_model_defs(cfg) -> dict:
    defs = {
        "embed": ((cfg.vocab_padded, cfg.d_model), "embed"),
        "final_norm": {"w": ((cfg.d_model,), "rep")},
        "layers": dense_layer_defs(cfg),
    }
    if cfg.norm == "layernorm":
        defs["final_norm"]["b"] = ((cfg.d_model,), "rep")
    if not cfg.tie_embeddings:
        defs["lm_head"] = ((cfg.d_model, cfg.vocab_padded), "col")
    return defs


# ------------------------------------------------------- chunked attention
def chunked_attention(q, k, v, *, causal=True, window=0, attn_softcap=0.0,
                      chunk=1024, q_offset=0):
    """Query-chunked GQA attention, bounded score memory.  q (B, Sq, H,
    hd), k/v (B, Sk, KV, hd); ``causal`` masks keys past each query (off:
    Whisper's encoder and cross-attention, every key live); ``window`` > 0
    is a sliding window (a local layer), 0 a global layer.

    The reference scores each query chunk against all of K/V.  Here a
    causal chunk gets only the keys its masks can leave live (none past
    its last query; with a window, none more than ``window − 1`` before
    its first): a masked key's probability is exp(NEG_INF − max) = 0
    exactly in the reference, so the softmax sums the same terms, and a
    32k-token prefill scores ~2k keys per query in its sliding-window
    layers instead of 32k.  A non-causal chunk scores all of K/V, as the
    reference's does.  ``q_offset`` is the position of q's first query
    (keys start at 0).  On DTensors each rank attends its own block
    (``_on_mesh``)."""
    if isinstance(q, DTensor):
        return _on_mesh(functools.partial(
            chunked_attention, causal=causal, window=window,
            attn_softcap=attn_softcap, chunk=chunk), q, k, v, q_offset)
    Sq = q.shape[1]
    if Sq <= chunk:
        return _attn_block(q, k, v, causal=causal, window=window,
                           attn_softcap=attn_softcap, q_offset=q_offset)
    assert Sq % chunk == 0
    outs = []
    for i in range(0, Sq, chunk):
        a = q_offset + i
        hi = min(k.shape[1], a + chunk) if causal else k.shape[1]
        lo = max(0, a - window + 1) if window > 0 else 0
        outs.append(_attn_block(q[:, i:i + chunk], k[:, lo:hi], v[:, lo:hi],
                                causal=causal, window=window,
                                attn_softcap=attn_softcap, q_offset=a,
                                k_offset=lo))
    return torch.cat(outs, dim=1)


def _contiguous_stride(shape):
    return torch.empty(shape, device="meta").stride()


def _local_blocks(q, k, v, kv_place=None):
    """Each rank's blocks of q (B, Sq, H, hd) and k/v (B, Sk, KV, hd)
    DTensors for attention: q keeps its batch, head or query-sequence
    sharding; k/v follow its batch and head sharding (heads whole where
    KV does not divide) unless ``kv_place`` gives theirs; the local K/V
    heads are then picked for the local query heads (the repeat-KV
    broadcast).  → (q, k, v local, q's placements, global offsets of q's
    and k's blocks)."""
    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    # heads cut unevenly (25 over 16) would not merge back into features
    qp = [Replicate() if p.is_partial() or (
        isinstance(p, Shard) and p.dim == 2 and H % n) else p
        for p, n in zip(q.placements, mesh.mesh.shape)]
    if kv_place is None:
        kv_place = []
        for p, n in zip(qp, mesh.mesh.shape):
            if isinstance(p, Shard) and p.dim == 0:
                kv_place.append(Shard(0))
            elif (isinstance(p, Shard) and p.dim == 2 and KV % n == 0
                  and KV >= n):
                kv_place.append(Shard(2))
            else:
                kv_place.append(Replicate())
    q = q.redistribute(mesh, qp)
    k, v = (t.redistribute(mesh, kv_place) for t in (k, v))
    qoff = local_block(q.shape, mesh, qp)[1]
    koff = local_block(k.shape, mesh, kv_place)[1]
    ql = q.to_local()
    kl, vl = (t.to_local(grad_placements=_grad_place(t, q)) for t in (k, v))
    if not (H == KV and kl.shape[2] == ql.shape[2]):
        heads = ((qoff[2] + torch.arange(ql.shape[2])) // (H // KV)
                 - koff[2]).to(kl.device)
        kl, vl = kl.index_select(2, heads), vl.index_select(2, heads)
    return ql, kl, vl, qp, qoff, koff


def _wrap(out, like, place):
    """A local attention output as the DTensor of ``like``'s shape."""
    return DTensor.from_local(out.contiguous(), like.device_mesh, place,
                              run_check=False, shape=like.shape,
                              stride=_contiguous_stride(like.shape))


def _on_mesh(attend, q, k, v, q_offset):
    """``attend`` (the plain chunked attention) on every rank's block of
    DTensor q/k/v: batch and heads as q is sharded, a query-sequence
    shard against all of K/V at its own offset."""
    ql, kl, vl, qp, qoff, _ = _local_blocks(q, k, v)
    out = attend(ql, kl, vl, q_offset=q_offset + qoff[1])
    return _wrap(out, q, qp)


def _repeat_kv(k, H):
    KV = k.shape[2]
    return k if KV == H else torch.repeat_interleave(k, H // KV, dim=2)


def _scores(q, k, attn_softcap):
    """(B, H, Sq, Sk) float32 scores of q (B, Sq, H, hd) against k (B, Sk,
    H, hd): the product in the activation dtype (einsum "bqhd,bkhd->bhqk"),
    then float32, ``/ √hd``, soft-capped."""
    scores = (q.transpose(1, 2) @ k.permute(0, 2, 3, 1)).float()
    scores = scores / math.sqrt(q.shape[-1])
    return softcap(scores, attn_softcap) if attn_softcap > 0 else scores


def _attn_block(q, k, v, *, causal=True, window, attn_softcap=0.0,
                q_offset=0, k_offset=0):
    """GQA via repeat-KV (K/V broadcast to the H query heads).  Query i
    sits at position ``q_offset + i``, key j at ``k_offset + j``; without
    ``causal`` or ``window`` no key is masked."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    scores = _scores(q, k, attn_softcap)
    if causal or window > 0:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(Sk, device=q.device) + k_offset
        mask = (kpos[None, :] <= qpos[:, None] if causal else
                torch.ones(Sq, Sk, dtype=torch.bool, device=q.device))
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        scores.masked_fill_(~mask, NEG_INF)  # in place: the (B,H,Sq,Sk) f32
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return (probs @ v.transpose(1, 2)).transpose(1, 2)      # (B, Sq, H, hd)


def decode_attn(q, ck, cv, pos, *, window=0, attn_softcap=0.0):
    """One query position ``pos`` (a 0-d device tensor) against a whole
    cache ck/cv (B, Smax, KV, hd): slots ≤ ``pos`` are live, and with a
    window only those > ``pos − window``.  Nothing is read on the host,
    so the step can be captured.  A ring buffer passes its last slot
    index as ``pos`` (slot order is irrelevant to the softmax sum).  On
    DTensors see ``_decode_on_mesh``."""
    if isinstance(q, DTensor):
        return _decode_on_mesh(q, ck, cv, pos, window=window,
                               attn_softcap=attn_softcap)
    scores = _decode_scores(q, ck, pos, window, attn_softcap, 0)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return (probs @ _repeat_kv(cv, q.shape[2]).transpose(1, 2)).transpose(1, 2)


def _decode_scores(q, ck, pos, window, attn_softcap, k_offset):
    """Float32 scores of q against the cache rows ck, slot ``k_offset +
    j`` for row j, masked outside the live slots."""
    scores = _scores(q, _repeat_kv(ck, q.shape[2]), attn_softcap)
    kpos = torch.arange(ck.shape[1], device=q.device) + k_offset
    live = kpos <= pos
    if window > 0:
        live &= kpos > pos - window
    return scores.masked_fill(~live, NEG_INF)


def _decode_on_mesh(q, ck, cv, pos, *, window, attn_softcap):
    """``decode_attn`` on DTensors: each rank scores the query against its
    block of the cache as the cache lies (batch, KV heads or, with
    ``shard_cache_seq``, slots).  Over a slot-sharded mesh dimension the
    softmax is merged across ranks: the max and the sum of exps are
    reduced, then the probability-weighted values summed (the cache is
    never gathered)."""
    mesh = q.device_mesh
    cp = list(ck.placements)
    seq = [isinstance(p, Shard) and p.dim == 1 for p in cp]
    qp = []
    for p, c, n in zip(q.placements, cp, mesh.mesh.shape):
        if isinstance(c, Shard) and c.dim in (0, 2):
            qp.append(c)
        elif (isinstance(p, Shard) and p.dim == 2 and not isinstance(c, Shard)
              and q.shape[2] % n == 0):
            qp.append(p)
        else:
            qp.append(Replicate())
    kv_place = [c if isinstance(c, Shard) and c.dim in (0, 1, 2)
                else Replicate() for c in cp]
    q = q.redistribute(mesh, qp)
    ql, kl, vl, qp, _, koff = _local_blocks(q, ck, cv, kv_place)
    pos = pos.to_local() if isinstance(pos, DTensor) else pos
    scores = _decode_scores(ql, kl, pos, window, attn_softcap, koff[1])
    if not any(seq):
        probs = torch.softmax(scores, dim=-1).to(ql.dtype)
        return _wrap((probs @ vl.transpose(1, 2)).transpose(1, 2), q, qp)
    from torch.distributed.tensor import Partial

    def merged(t, op):
        """``t`` reduced with ``op`` over the slot-sharded dims."""
        place = [Partial(op) if s else p for s, p in zip(seq, qp)]
        d = DTensor.from_local(t, mesh, place, run_check=False)
        return d.redistribute(mesh, [Replicate() if s else p
                                     for s, p in zip(seq, qp)]).to_local()

    m = merged(scores.amax(-1, keepdim=True), "max")
    e = torch.exp(scores - m)
    total = merged(e.sum(-1, keepdim=True), "sum")
    part = ((e / total).to(ql.dtype) @ vl.transpose(1, 2)).transpose(1, 2)
    return _wrap(merged(part, "sum"), q, qp)


# ------------------------------------------------------------------- MoE
def top_k(logits, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    the lower index first on a tie (a stable sort; ``torch.topk``
    promises no order among equal values)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _positions_in_expert(eidx, E: int):
    """Rank of each entry within its expert along axis −1 (the count of
    earlier entries routed to the same expert)."""
    onehot = torch.nn.functional.one_hot(eidx, E)         # (..., T·k, E)
    ranks = onehot.cumsum(-2) - onehot
    return ranks.gather(-1, eidx[..., None])[..., 0]


def _experts(buf, ewg, ewu, ewd, act):
    """The gated expert FFN on the (…, E, cap, D) buffer, batched over E."""
    a = activation(act)
    dt = buf.dtype
    return (a(buf @ ewg.to(dt)) * (buf @ ewu.to(dt))) @ ewd.to(dt)


def _route(x, router_w, top_k_):
    """Router logits (the bf16 product widened to float32), the top-k
    experts and their softmaxed gates in the activation dtype."""
    logits = (x @ router_w.to(x.dtype)).float()
    gates, eidx = top_k(logits, top_k_)
    return torch.softmax(gates, dim=-1).to(x.dtype), eidx


MOE_CAPACITY_FACTOR = 1.25        # the reference's default


def expert_capacity(T: int, E: int, top_k: int,
                    capacity_factor: float = MOE_CAPACITY_FACTOR) -> int:
    """Each expert's queue length for T tokens, the reference's expression
    (a Python float, so the same rounding)."""
    return max(8, int(capacity_factor * top_k * T / E))


def moe_ffn(x, router_w, ewg, ewu, ewd, *, top_k: int, act: str,
            capacity_factor: float = MOE_CAPACITY_FACTOR):
    """Top-k dispatch with fixed expert capacity (static shapes; overflow
    entries are dropped).  x (B, S, D) → (B, S, D).  The ``moe_dispatch``
    perf option picks the reference's dispatch: ``global``, one queue per
    expert over all B·S tokens, ``expert_capacity`` long, or ``batched``
    (``_moe_ffn_batched``).  ``shard_map`` runs ``batched``: on DTensors
    that already runs on each rank's block with one sum over model
    (``_moe_on_mesh``), the design of the reference's ``shard_map``
    variant, and without a mesh the reference falls back to it too.

    The reference scatter-adds each (token, slot) into its (expert,
    position) row, dropped entries adding exact zeros into row cap − 1.
    Every kept entry owns its row, so here the rows are written (no
    atomic, no order to depend on): the kept entries into theirs, the
    dropped ones into a spare row that is cut off.  The combine reads the
    same rows and the spare one (zeros) and weights them by the gate."""
    dispatch = perf_option("moe_dispatch")
    fn = _moe_ffn_global if dispatch == "global" else _moe_ffn_batched
    if isinstance(x, DTensor):
        return _moe_on_mesh(fn, x, router_w, ewg, ewu, ewd, top_k=top_k,
                            act=act, capacity_factor=capacity_factor,
                            per_sequence=dispatch != "global")
    return fn(x, router_w, ewg, ewu, ewd, top_k=top_k, act=act,
              capacity_factor=capacity_factor)


def _moe_ffn_global(x, router_w, ewg, ewu, ewd, *, top_k: int, act: str,
                    capacity_factor: float):
    """The global dispatch on plain tensors (``moe_ffn``'s default)."""
    B, S, D = x.shape
    E = router_w.shape[-1]
    T = B * S
    xt = x.reshape(T, D)
    gates, eidx = _route(xt, router_w, top_k)                 # (T, k)
    cap = expert_capacity(T, E, top_k, capacity_factor)
    flat = eidx.reshape(-1)                                   # (T·k,)
    pos = _positions_in_expert(flat, E)
    rows = torch.where(pos < cap, flat * cap + pos, E * cap)  # spare: E·cap
    buf = torch.index_copy(x.new_zeros(E * cap + 1, D), 0, rows,
                           xt.repeat_interleave(top_k, dim=0))
    y = _experts(buf[:-1].view(E, cap, D), ewg, ewu, ewd, act)
    y = torch.cat([y.reshape(E * cap, D), y.new_zeros(1, D)])
    out = y[rows] * gates.reshape(-1, 1)
    return out.reshape(T, top_k, D).sum(1).reshape(B, S, D)


def batched_capacity(S: int, E: int, top_k: int,
                     capacity_factor: float = MOE_CAPACITY_FACTOR) -> int:
    """Each expert's queue length per sequence in the batched dispatch:
    the reference's expression, a multiple of 16, at least 8."""
    return max(8, -(-int(capacity_factor * top_k * S / E) // 16) * 16)


def _moe_ffn_batched(x, router_w, ewg, ewu, ewd, *, top_k: int, act: str,
                     capacity_factor: float):
    """Per-sequence dispatch: every tensor keeps the batch dim (each
    sequence's entries queue per expert, ``batched_capacity`` long), so a
    batch-sharded input dispatches on its own shard.  The gate and up
    projections run as one product against their concatenation, as the
    reference fuses them.  Where the reference scatter-sets its token map
    and lets every dropped entry of an overflowing expert also write slot
    cap − 1 (its fault: the kept token there gets a dropped token's
    row), the port writes dropped entries to a spare row, as ``moe_ffn``
    does."""
    B, S, D = x.shape
    E = router_w.shape[-1]
    k = top_k
    gates, eidx = _route(x, router_w, k)                      # (B, S, k)
    cap = batched_capacity(S, E, k, capacity_factor)
    eflat = eidx.reshape(B, S * k)
    pos = _positions_in_expert(eflat, E)                      # per sequence
    rows = torch.where(pos < cap, eflat * cap + pos, E * cap)
    src = x.repeat_interleave(k, dim=1)                       # (B, S·k, D)
    buf = x.new_zeros(B, E * cap + 1, D).scatter(
        1, rows[..., None].expand(-1, -1, D), src)
    # the reference's constraint; the identity on the plain blocks that
    # every rank dispatches here
    buf = constrain_moe_buf(buf[:, :-1].reshape(B, E, cap, D))
    a = activation(act)
    dt = x.dtype
    ff = ewg.shape[-1]
    hu = buf @ torch.cat([ewg, ewu], -1).to(dt)               # (B,E,cap,2F)
    y = (a(hu[..., :ff]) * hu[..., ff:]) @ ewd.to(dt)          # (B,E,cap,D)
    y = torch.cat([y.reshape(B, E * cap, D), y.new_zeros(B, 1, D)], dim=1)
    out = y.gather(1, rows[..., None].expand(-1, -1, D))
    out = out * gates.reshape(B, S * k, 1)
    return out.reshape(B, S, k, D).sum(2)


def _moe_on_mesh(fn, x, router_w, ewg, ewu, ewd, *, top_k, act,
                 capacity_factor, per_sequence):
    """An MoE dispatch ``fn`` run by every rank on its own block: the
    batch over the data axes (``per_sequence``; the global queue needs
    every token, so without it each data rank runs the whole batch), the
    expert ff over model where it divides, and one sum over model of the
    (B, S, D) output.  Routing, queues and the expert products are local
    tensor work."""
    from torch.distributed.tensor import Partial
    from .sharding_ctx import _SumOver, _as_dtensor, _replicated_as
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    parts = mesh.mesh.shape[names.index("model")] if "model" in names else 1
    ff_split = parts > 1 and ewg.shape[-1] % parts == 0
    R = Replicate()
    on = lambda data, model: [data if n in ("pod", "data") else model
                              for n in names]
    split = on(per_sequence, ff_split)     # where the work is cut
    batch = Shard(0) if per_sequence else R
    w_in, w_out = (Shard(2), Shard(1)) if ff_split else (R, R)
    local = []
    for t, place in ((x, on(batch, R)), (router_w, on(R, R)),
                     (ewg, on(R, w_in)), (ewu, on(R, w_in)),
                     (ewd, on(R, w_out))):
        t = _replicated_as(t, x).redistribute(mesh, place)
        # a block held whole where the work is cut gets a partial gradient
        local.append(t.to_local(grad_placements=[
            Partial() if cut and not isinstance(p, Shard) else p
            for p, cut in zip(place, split)]))
    y = fn(*local, top_k=top_k, act=act, capacity_factor=capacity_factor)
    if ff_split:
        y = _SumOver.apply(y, mesh, on(batch, Partial()))
    return _as_dtensor(y, mesh, on(batch, R), x.shape)


# ------------------------------------------------------------ layer body
def is_local(cfg, i: int) -> bool:
    """Whether layer ``i`` attends through ``cfg.sliding_window``: every
    layer with a window, or with gemma2's alternation the even ones."""
    return cfg.sliding_window > 0 and (not cfg.alternate_local_global
                                       or i % 2 == 0)


def dense_layer(x, lp, cfg, *, cos, sin, rot, local, cache=None, pos=None,
                chunk=1024):
    """One transformer block; ``local`` applies the sliding window.
    ``cache=(k, v)`` (B, Smax, KV, hd) → decode: this layer's K/V are
    written in place at ``pos`` (a 0-d device tensor) and attention runs
    over the whole cache."""
    norm = functools.partial(apply_norm, kind=cfg.norm,
                             plus_one=cfg.norm_plus_one)
    h = norm(x, lp["ln1"])
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = constrain_attn_q(split_heads(q, cfg.n_heads, cfg.head_dim))
    k = constrain_heads(split_heads(k, cfg.n_kv, cfg.head_dim))
    v = constrain_heads(split_heads(v, cfg.n_kv, cfg.head_dim))
    q = apply_rope(q, cos, sin, rot)
    k = apply_rope(k, cos, sin, rot)
    window = cfg.sliding_window if local else 0
    if cache is not None:
        ck, cv = cache
        at = pos.reshape(1)
        write_at(ck, 1, at, k)
        write_at(cv, 1, at, v)
        attn = decode_attn(q, ck, cv, pos, window=window,
                           attn_softcap=cfg.attn_softcap)
    else:
        attn = chunked_attention(q, k, v, window=window,
                                 attn_softcap=cfg.attn_softcap, chunk=chunk)
    attn = merge_heads(constrain_heads(attn)) @ lp["wo"]
    if cfg.post_block_norm:
        attn = norm(attn, lp["ln1_post"])
    x = constrain_hidden(x + attn)

    h = norm(x, lp["ln2"])
    if cfg.n_experts:
        f = moe_ffn(h, lp["router"], lp["ewg"], lp["ewu"], lp["ewd"],
                    top_k=cfg.top_k, act=cfg.act)
    else:
        f = gated_mlp(h, lp["wg"], lp["wu"], lp["wd"], act=cfg.act)
    if cfg.post_block_norm:
        f = norm(f, lp["ln2_post"])
    return constrain_hidden(x + f)


# --------------------------------------------------------------- forward
def dense_forward(params, cfg, embeds, *, remat=True, chunk=1024):
    """embeds (B, S, D) → final hidden states (B, S, D)."""
    S = embeds.shape[1]
    positions = torch.arange(S, device=embeds.device)[None, :]
    cos, sin, rot = rope_tables(positions, cfg.head_dim, cfg.rope_fraction,
                                cfg.rope_base)
    stack = params["layers"]
    x = embeds
    ctx = remat_context() if remat else None
    for i in range(stack["wq"].shape[0]):
        blk = functools.partial(dense_layer, cfg=cfg, cos=cos, sin=sin,
                                rot=rot, local=is_local(cfg, i), chunk=chunk)
        lp = layer_params(stack, i)
        if not remat:
            x = blk(x, lp)
        elif ctx is None:
            x = checkpoint(blk, x, lp, use_reentrant=False)
        else:
            x = checkpoint(blk, x, lp, use_reentrant=False, context_fn=ctx)
    return apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_plus_one)


def dense_decode_step(params, cfg, token_embed, cache, pos):
    """token_embed (B, 1, D); cache {"k", "v"}: (L, B, Smax, KV, hd),
    updated in place at ``pos`` (a 0-d int64 device tensor, never read on
    the host) and returned with the final hidden state (B, 1, D)."""
    cos, sin, rot = rope_tables(pos.reshape(1, 1), cfg.head_dim,
                                cfg.rope_fraction, cfg.rope_base)
    stack = params["layers"]
    x = token_embed
    for i in range(stack["wq"].shape[0]):
        x = dense_layer(x, layer_params(stack, i), cfg, cos=cos, sin=sin,
                        rot=rot, local=is_local(cfg, i),
                        cache=(cache["k"][i], cache["v"][i]), pos=pos)
    x = apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_plus_one)
    return x, cache


# ------------------------------------------------------------------ loss
def logits_for(x, params, cfg):
    """Hidden states (B, S, D) → float32 logits (B, S, vocab_padded)
    through the untied ``lm_head`` (D, Vp) or the tied embedding:
    the product in the activation dtype, widened, soft-capped
    (``cfg.logit_softcap``), the vocab padding beyond ``cfg.vocab``
    masked with ``NEG_INF``."""
    W = params.get("lm_head")
    W = params["embed"].T if W is None else W
    logits = (x @ W.to(x.dtype)).float()
    if cfg.logit_softcap > 0:
        logits = softcap(logits, cfg.logit_softcap)
    if cfg.vocab_padded > cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, NEG_INF)
    return logits


def chunked_xent(x, embed, labels, *, logit_softcap=0.0, chunk=512,
                 lm_head=None, valid_vocab=None):
    """Sequence-chunked mean CE of hidden states x (B, S, D) against the
    tied embedding (``lm_head=None``) or an untied (D, V) head: the
    logits are formed a chunk at a time (autograd keeps each chunk's for
    the backward, as the reference's ``lax.scan`` keeps its residuals).
    The chunk
    count is ``S // chunk`` lowered until it divides S, as in the
    reference; each chunk's logits are the bf16 product widened to
    float32, soft-capped, masked past ``valid_vocab`` with ``NEG_INF``.
    The label term is a gather, which picks the same float32 as the
    reference's one-hot contraction; on vocab-sharded DTensor logits it is
    that contraction (a select and a sum: each rank's partial sum, then
    one reduction over model).  The mean is over B·S."""
    B, S, D = x.shape
    W = embed.T if lm_head is None else lm_head          # (D, V)
    V = W.shape[-1]
    nc = max(1, S // chunk)
    while S % nc:                     # largest divisor ≤ target count
        nc -= 1
    chunk = S // nc
    W = W.to(x.dtype)
    labels = labels.long()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, chunk):
        logits = (x[:, i:i + chunk] @ W).float()
        if logit_softcap > 0:
            logits = softcap(logits, logit_softcap)
        if valid_vocab is not None and valid_vocab < V:
            pad = torch.arange(V, device=x.device) >= valid_vocab
            logits = logits.masked_fill(pad, NEG_INF)
        lse = torch.logsumexp(logits, dim=-1)
        lab = labels[:, i:i + chunk, None]
        if isinstance(logits, DTensor):     # vocab-parallel: the one-hot sum
            hit = torch.arange(V, device=x.device) == lab
            ll = torch.where(hit, logits, 0.0).sum(-1)
        else:
            ll = torch.gather(logits, -1, lab)[..., 0]
        total = total + (lse - ll).sum()
    return total / (B * S)
