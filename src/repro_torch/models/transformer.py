"""What the hybrid family needs of the JAX package's decoder-only
transformer: query-chunked causal GQA attention, the tied unembedding and
the sequence-chunked training loss.

Attention is plain PyTorch (``matmul`` + softmax) with the reference's
masks and casts, as the JAX package leaves it to XLA: the bf16 score
product is rounded to bf16 and widened to float32, masked with
``NEG_INF``, softmaxed in float32 and cast back to bf16 before the
product with V.
"""
from __future__ import annotations

import math

import torch

from .common import NEG_INF, softcap


def chunked_attention(q, k, v, *, window=0, chunk=1024):
    """Query-chunked causal GQA attention, bounded score memory.  q (B,
    Sq, H, hd), k/v (B, Sk, KV, hd); ``window`` > 0 is a sliding window.

    The reference scores each query chunk against all of K/V.  Here a
    chunk gets only the keys its masks can leave live (none past its last
    query; with a window, none more than ``window − 1`` before its
    first): a masked key's probability is exp(NEG_INF − max) = 0 exactly
    in the reference, so the softmax sums the same terms, and a
    32k-token prefill scores ~2k keys per query in its sliding-window
    layers instead of 32k."""
    Sq = q.shape[1]
    if Sq <= chunk:
        return _attn_block(q, k, v, window=window)
    assert Sq % chunk == 0
    outs = []
    for i in range(0, Sq, chunk):
        hi = min(k.shape[1], i + chunk)
        lo = max(0, i - window + 1) if window > 0 else 0
        outs.append(_attn_block(q[:, i:i + chunk], k[:, lo:hi], v[:, lo:hi],
                                window=window, q_offset=i, k_offset=lo))
    return torch.cat(outs, dim=1)


def _repeat_kv(k, H):
    KV = k.shape[2]
    return k if KV == H else torch.repeat_interleave(k, H // KV, dim=2)


def _attn_block(q, k, v, *, window, q_offset=0, k_offset=0):
    """GQA via repeat-KV (K/V broadcast to the H query heads).  Query i
    sits at position ``q_offset + i``, key j at ``k_offset + j``."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    # einsum "bqhd,bkhd->bhqk" in the activation dtype, then float32
    scores = (q.transpose(1, 2) @ k.permute(0, 2, 3, 1)).float()
    scores = scores / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device) + k_offset
    mask = kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores.masked_fill_(~mask, NEG_INF)      # in place: the (B,H,Sq,Sk) f32
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return (probs @ v.transpose(1, 2)).transpose(1, 2)      # (B, Sq, H, hd)


def logits_for(x, params, cfg):
    """Hidden states (B, S, D) → float32 logits (B, S, vocab_padded)
    through the tied embedding; the vocab padding beyond ``cfg.vocab`` is
    masked with ``NEG_INF``."""
    logits = (x @ params["embed"].T.to(x.dtype)).float()
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
    reference's one-hot contraction.  The mean is over B·S."""
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
        ll = torch.gather(logits, -1, labels[:, i:i + chunk, None])[..., 0]
        total = total + (lse - ll).sum()
    return total / (B * S)
