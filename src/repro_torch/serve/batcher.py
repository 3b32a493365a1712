"""Dynamic request batching — coalesce sampled subgraphs per tick.

Requests are queued in arrival order and drained into batches whose
block-diagonal union stays inside the policy's largest bucket (greedy
FIFO: a batch closes when the next request would overflow the node or
edge ceiling, or the per-batch request cap).  Batch composition is a
pure function of the queue contents — no wall-clock dependence — so a
seeded stream replays deterministically, which is what the soak test
asserts.

``synthetic_stream`` generates the seeded bursty workload (geometric
burst sizes, exponential inter-burst gaps, mixed fanouts/seed counts)
used by the tests, ``apps/serve_gnn`` and ``chip_smoke.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class SubgraphRequest:
    """One inference request: expand ``seeds`` by ``fanouts`` and return
    the served model's outputs on the seed nodes."""

    rid: str
    seeds: tuple
    fanouts: tuple
    sample_seed: int = 0
    arrival_s: float = 0.0


@dataclass
class SampledRequest:
    """A request after the sampling stage: its global node set, the
    relabeled induced subgraph, and where its seeds sit locally."""

    req: SubgraphRequest
    nodes: np.ndarray          # sorted unique global node ids
    sub: "object"              # CSRMatrix, local ids
    seed_local: np.ndarray     # positions of req.seeds within nodes
    t_submit: float = 0.0

    @property
    def n(self) -> int:
        return int(self.nodes.size)

    @property
    def e(self) -> int:
        return int(self.sub.indices.size)


@dataclass
class RequestBatcher:
    """FIFO queue + greedy coalescing under (n_max, e_max) ceilings."""

    n_max: int
    e_max: int
    max_batch: int = 32
    _queue: list = field(default_factory=list)

    def add(self, sr: SampledRequest):
        if sr.n > self.n_max or sr.e > self.e_max:
            raise ValueError(
                f"request {sr.req.rid} ({sr.n} nodes, {sr.e} edges) "
                f"exceeds the largest bucket ({self.n_max}, {self.e_max})")
        self._queue.append(sr)

    def __len__(self) -> int:
        return len(self._queue)

    def drain(self) -> list:
        """Split the queue into batches (lists of SampledRequest), FIFO,
        each fitting the ceilings.  Empties the queue."""
        batches, cur, n_tot, e_tot = [], [], 0, 0
        for sr in self._queue:
            if cur and (n_tot + sr.n > self.n_max
                        or e_tot + sr.e > self.e_max
                        or len(cur) >= self.max_batch):
                batches.append(cur)
                cur, n_tot, e_tot = [], 0, 0
            cur.append(sr)
            n_tot += sr.n
            e_tot += sr.e
        if cur:
            batches.append(cur)
        self._queue = []
        return batches


def synthetic_stream(n_requests: int, n_nodes: int, *, seed: int = 0,
                     max_seeds: int = 4,
                     fanout_choices=((4, 2), (8, 4), (2, 2), (6,)),
                     burst_mean: float = 3.0,
                     gap_mean_s: float = 0.01) -> list:
    """Seeded bursty request stream against an ``n_nodes`` graph.

    Bursts of geometric size arrive after exponential gaps; each request
    draws 1..max_seeds random seed nodes, a random fanout profile, and
    its own derived sampling seed.  Fully deterministic in ``seed``.
    """
    rng = np.random.default_rng(seed)
    out = []
    t = 0.0
    i = 0
    while i < n_requests:
        t += float(rng.exponential(gap_mean_s))
        burst = min(int(rng.geometric(1.0 / burst_mean)), n_requests - i)
        for _ in range(burst):
            k = int(rng.integers(1, max_seeds + 1))
            seeds = tuple(int(s) for s in rng.integers(0, n_nodes, k))
            fanouts = fanout_choices[int(rng.integers(len(fanout_choices)))]
            out.append(SubgraphRequest(
                rid=f"r{i}", seeds=seeds, fanouts=tuple(fanouts),
                sample_seed=int(rng.integers(1 << 31)), arrival_s=t))
            i += 1
    return out
