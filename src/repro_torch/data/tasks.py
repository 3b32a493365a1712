"""Synthetic node-classification tasks (an OGB analogue for the GNN
training runs): community-structured graphs with class-dependent
features, learnable by message passing and the same seed for seed as the
JAX package's."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.sparse import CSRMatrix

from .graphs import sbm


@dataclass
class NodeTask:
    csr: CSRMatrix           # raw adjacency (unnormalized)
    features: np.ndarray     # (n, f) float32
    labels: np.ndarray       # (n,) int32 class ids, or (n, C) float32
                             # multi-hot (a multi-label task, C classes)
    train_mask: np.ndarray   # (n,) float32
    val_mask: np.ndarray
    n_classes: int


def community_task(n_blocks=8, block_size=128, feat_dim=16, p_in=0.15,
                   noise=1.0, train_frac=0.6, seed=0) -> NodeTask:
    """``n_blocks`` communities of ``block_size`` nodes (``sbm``), one
    class each; features are the class centre plus Gaussian noise; a
    ``train_frac`` random share of the nodes trains, the rest validates."""
    rng = np.random.default_rng(seed)
    csr = sbm(n_blocks, block_size, p_in, 1.0, seed=seed)
    n = csr.n_rows
    labels = np.repeat(np.arange(n_blocks), block_size).astype(np.int32)
    centers = rng.standard_normal((n_blocks, feat_dim)).astype(np.float32)
    feats = centers[labels] + noise * rng.standard_normal(
        (n, feat_dim)).astype(np.float32)
    order = rng.permutation(n)
    n_train = int(train_frac * n)
    train_mask = np.zeros(n, np.float32)
    val_mask = np.zeros(n, np.float32)
    train_mask[order[:n_train]] = 1.0
    val_mask[order[n_train:]] = 1.0
    return NodeTask(csr, feats, labels, train_mask, val_mask, n_blocks)
