"""Deterministic, stateless synthetic LM data (numpy only; the JAX
package's ``data/tokens.py``, array for array).

``batch_for_step(cfg, B, S, step)`` is a pure function of (seed, step):
a restart never replays or skips data, which is the contract the
checkpoint manager relies on.  The token stream is a noisy Markov chain,
so small models show a clearly falling loss.  A VLM batch also has
patch embeddings and an encoder-decoder batch stub audio frames, drawn
after the tokens from the same generator.
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int, step: int):
    return np.random.Generator(np.random.Philox(key=seed, counter=step))


def batch_for_step(cfg, batch: int, seq: int, step: int, seed: int = 0,
                   order: int = 64):
    """``{"tokens", "labels"}`` int32 (batch, seq) of step ``step``:
    labels are the tokens shifted by one; for a VLM also ``patches``,
    float32 (batch, n_patches, d_model), for an encoder-decoder model
    ``frames``, float32 (batch, seq, d_model).  ``order`` is unused, as in
    the reference."""
    rng = _rng(seed, step)
    V = cfg.vocab
    # Markov structure: next ≈ (prev · a + b) mod V with noise
    a = 31
    stream = np.zeros((batch, seq + 1), np.int64)
    stream[:, 0] = rng.integers(0, V, batch)
    noise = rng.random((batch, seq)) < 0.15
    rand = rng.integers(0, V, (batch, seq))
    for t in range(seq):
        nxt = (stream[:, t] * a + 7) % V
        stream[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
    out = {"tokens": stream[:, :-1].astype(np.int32),
           "labels": stream[:, 1:].astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (batch, seq, cfg.d_model)).astype(np.float32)
    return out
