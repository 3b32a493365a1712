"""ML-based SpMM-decider (paper §5): a random forest over Table-3 features
predicting the optimal ⟨W,F,V,S⟩.  Numpy only: CART trees with gini
impurity, bootstrap sampling, and per-split feature subsampling — the
standard random-forest recipe the paper relies on for its "lightweight,
low-overfitting-risk" argument.  The code is the JAX package's, so the
same samples and seed grow the same trees; ``repro_torch.convert.
decider_to_torch`` carries a forest trained there across.
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass, field

import numpy as np

from repro_torch.obs import decisions as _obs_decisions, trace as _obs_trace

from .features import MatrixFeatures, extract_features
from .pcsr import SpMMConfig, config_space
from .sparse import CSRMatrix


# ------------------------------------------------------------------ trees
class _Node:
    __slots__ = ("feature", "threshold", "left", "right", "value")

    def __init__(self, value=None):
        self.feature = -1
        self.threshold = 0.0
        self.left = None
        self.right = None
        self.value = value            # class-probability vector at leaves


class DecisionTree:
    def __init__(self, max_depth=14, min_samples_leaf=2, max_features=None,
                 rng=None):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.rng = rng or np.random.default_rng(0)
        self.n_classes = 0
        self.root = None

    def fit(self, X, y, n_classes):
        self.n_classes = n_classes
        self.root = self._grow(np.asarray(X, np.float64),
                               np.asarray(y, np.int64), 0)
        return self

    def _leaf(self, y):
        counts = np.bincount(y, minlength=self.n_classes).astype(np.float64)
        return _Node(value=counts / max(1.0, counts.sum()))

    def _gini(self, y):
        if y.shape[0] == 0:
            return 0.0
        p = np.bincount(y, minlength=self.n_classes) / y.shape[0]
        return 1.0 - (p * p).sum()

    def _grow(self, X, y, depth):
        n, nf = X.shape
        if (depth >= self.max_depth or n < 2 * self.min_samples_leaf
                or np.unique(y).shape[0] == 1):
            return self._leaf(y)
        k = self.max_features or max(1, int(np.sqrt(nf)))
        feats = self.rng.choice(nf, size=min(k, nf), replace=False)
        best = (None, None, np.inf)
        parent_gini = self._gini(y)
        for f in feats:
            xs = X[:, f]
            order = np.argsort(xs, kind="stable")
            xs_s, y_s = xs[order], y[order]
            # candidate thresholds at class-boundary midpoints (subsampled)
            uniq = np.unique(xs_s)
            if uniq.shape[0] < 2:
                continue
            cand = (uniq[:-1] + uniq[1:]) / 2.0
            if cand.shape[0] > 32:
                cand = cand[np.linspace(0, cand.shape[0] - 1, 32, dtype=int)]
            for thr in cand:
                mask = xs <= thr
                nl = int(mask.sum())
                if nl < self.min_samples_leaf or n - nl < self.min_samples_leaf:
                    continue
                g = (nl * self._gini(y[mask])
                     + (n - nl) * self._gini(y[~mask])) / n
                if g < best[2]:
                    best = (f, thr, g)
        if best[0] is None or best[2] >= parent_gini - 1e-12:
            return self._leaf(y)
        f, thr, _ = best
        mask = X[:, f] <= thr
        node = _Node()
        node.feature, node.threshold = int(f), float(thr)
        node.left = self._grow(X[mask], y[mask], depth + 1)
        node.right = self._grow(X[~mask], y[~mask], depth + 1)
        return node

    def predict_proba(self, X):
        X = np.asarray(X, np.float64)
        out = np.empty((X.shape[0], self.n_classes))
        for i, x in enumerate(X):
            node = self.root
            while node.value is None:
                node = node.left if x[node.feature] <= node.threshold else node.right
            out[i] = node.value
        return out


class RandomForest:
    def __init__(self, n_estimators=60, max_depth=14, min_samples_leaf=2,
                 seed=0):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.seed = seed
        self.trees: list[DecisionTree] = []
        self.n_classes = 0

    def fit(self, X, y, n_classes):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.int64)
        self.n_classes = n_classes
        rng = np.random.default_rng(self.seed)
        self.trees = []
        for _ in range(self.n_estimators):
            idx = rng.integers(0, X.shape[0], X.shape[0])   # bootstrap
            t = DecisionTree(self.max_depth, self.min_samples_leaf,
                             rng=np.random.default_rng(rng.integers(2**31)))
            t.fit(X[idx], y[idx], n_classes)
            self.trees.append(t)
        return self

    def predict_proba(self, X):
        p = np.zeros((np.asarray(X).shape[0], self.n_classes))
        for t in self.trees:
            p += t.predict_proba(X)
        return p / len(self.trees)

    def predict(self, X):
        return self.predict_proba(X).argmax(axis=1)


# ---------------------------------------------------------------- decider
@dataclass
class SpMMDecider:
    """Predicts ⟨W,F,V,S⟩ from matrix features (+dim appended)."""

    space: list = field(default_factory=lambda: config_space(512, max_f=4))
    forest: RandomForest = field(default_factory=RandomForest)

    def __post_init__(self):
        self._cfg_to_id = {c: i for i, c in enumerate(self.space)}

    def encode(self, feats: MatrixFeatures, dim: int) -> np.ndarray:
        return feats.vector(dim)

    def fit(self, samples):
        """samples: list of (MatrixFeatures, dim, best_config)."""
        X = np.stack([self.encode(f, d) for f, d, _ in samples])
        y = np.array([self._cfg_to_id[c] for _, _, c in samples])
        self.forest.fit(X, y, n_classes=len(self.space))
        return self

    def predict(self, feats: MatrixFeatures, dim: int) -> SpMMConfig:
        proba = self.forest.predict_proba(self.encode(feats, dim)[None])[0]
        # mask configs whose F exceeds this dim's tile range
        valid = np.array([c.F <= max(1, -(-dim // 128)) for c in self.space])
        proba = np.where(valid, proba, -1.0)
        chosen = self.space[int(proba.argmax())]
        if _obs_trace.trace_enabled():
            _obs_decisions.record_decision(
                source="decider", dim=dim, chosen=chosen,
                scores=[(c, p) for c, p in zip(self.space, proba) if p >= 0],
                snapshot=feats.as_dict())
        return chosen

    def predict_for(self, csr: CSRMatrix, dim: int) -> SpMMConfig:
        return self.predict(extract_features(csr), dim)

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path: str) -> "SpMMDecider":
        with open(path, "rb") as f:
            return pickle.load(f)
