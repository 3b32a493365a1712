"""GNNService — the request path, end to end.

``submit`` runs the sampling stage (seeded k-hop fanout-capped expansion
+ induced-subgraph extraction with local relabeling, span
``serve.sample``) and queues the result; ``tick`` drains the batcher,
and for each batch: coalesces the member subgraphs into one
block-diagonal union, picks the shape bucket, fetches the bucket's pack
from the cache (span ``serve.pack``, config pick amortized), packs the
union into the bucket geometry, and runs the geometry's
``BucketProgram`` (span ``serve.forward``): the batch's steering and
padded features are copied into the program's fixed buffers, and on a
card the forward captured at the geometry's first batch is replayed.
Per-request outputs are the forward's rows at each request's seed
positions, copied out before the next batch.

Everything is deterministic given the request stream: sampling is
seeded per request, batch composition is a pure function of queue
order, and the padded layouts are fixed per bucket.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.cost_model import H100, Hardware
from repro_torch.core.sparse import CSRMatrix
from repro_torch.data.graphs import extract_subgraph, sample_khop
from repro_torch.device import resolve_device
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import span

from .batcher import RequestBatcher, SampledRequest, SubgraphRequest
from .bucket import BucketPolicy, pack_subgraph
from .cache import SteeringPackCache
from .forward import BucketProgram, check_model


@dataclass
class RequestResult:
    rid: str
    outputs: np.ndarray        # (n_seeds, out_dim) rows for req.seeds
    bucket_key: str
    latency_s: float
    config: object = None      # the SpMMConfig the batch was served under
    sampled: SampledRequest | None = None   # kept when keep_subgraphs


def _model_dims(model: str, params) -> int:
    """Widest layer width — the config pick's embedding-dim argument."""
    if model == "gat":
        return max(int(l["wv"].shape[1]) for l in params)
    if model == "gin":
        return max(int(l["w1"].shape[1]) for l in params)
    return max(int(l["w"].shape[1]) for l in params)


def _union_csr(members) -> CSRMatrix:
    """Block-diagonal union of the members' local-id subgraphs."""
    n_tot = sum(sr.n for sr in members)
    indptr = [np.zeros(1, np.int64)]
    indices, data = [], []
    n_off = e_off = 0
    for sr in members:
        indptr.append(sr.sub.indptr[1:] + e_off)
        indices.append(sr.sub.indices + n_off)
        data.append(sr.sub.data)
        n_off += sr.n
        e_off += int(sr.sub.indices.size)
    return CSRMatrix(np.concatenate(indptr), np.concatenate(indices),
                     np.concatenate(data), n_tot, n_tot)


class GNNService:
    """Serve a GCN, GIN or (single-head) GAT over one base graph.

    ``csr`` is the propagation matrix to sample from (pre-normalize it
    for GCN: edge weights travel with the extracted edges), ``features``
    the ``(n_nodes, f)`` node features (numpy, host-resident), ``params``
    the model parameters (moved to the service's device).  ``device``
    defaults to CUDA and raises if there is none; pass ``device="cpu"``
    to serve through the kernel's plain version.  On a card each bucket
    geometry's forward is captured once as a CUDA graph and replayed
    (``BucketProgram``); ``graphs=False`` runs it eagerly over the same
    buffers, for comparison.  ``hardware`` is what the per-bucket config
    pick prices with, unless a trained ``decider``
    (``core.decider.SpMMDecider``) picks instead.  ``keep_subgraphs=True``
    retains each request's sampled subgraph on its result, for
    re-checking against ``reference_forward``.
    """

    def __init__(self, csr: CSRMatrix, features, params, *,
                 model: str = "gcn", device=None,
                 policy: BucketPolicy | None = None,
                 cache_capacity: int = 8, max_batch: int = 32,
                 keep_subgraphs: bool = False,
                 hardware: Hardware = H100, decider=None,
                 graphs: bool | None = None):
        check_model(model)
        self.device = resolve_device(device)
        if graphs is None:
            graphs = self.device.type == "cuda"
        if graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not "
                             f"{self.device}")
        self.graphs = graphs
        # one memory pool for the service's graphs: each batch's output
        # is copied out before the next replay
        self._pool = torch.cuda.graph_pool_handle() if graphs else None
        self.csr = csr
        self.features = np.asarray(features, np.float32)
        self.params = [{k: v.to(self.device) for k, v in layer.items()}
                       for layer in params]
        self.model = model
        self.policy = policy or BucketPolicy.default()
        self.keep_subgraphs = keep_subgraphs
        self.cache = SteeringPackCache(
            dim=_model_dims(model, params), capacity=cache_capacity,
            op="gat" if model == "gat" else "spmm", hardware=hardware,
            decider=decider)
        big = self.policy.largest
        self.batcher = RequestBatcher(n_max=big.n_ceil, e_max=big.e_ceil,
                                      max_batch=max_batch)
        self.batch_log: list = []       # (bucket_key, (rid, ...)) per batch
        self.requests_served = 0
        self._programs: dict = {}       # PackGeom → BucketProgram

    # ------------------------------------------------------------ intake
    def submit(self, req: SubgraphRequest) -> SampledRequest:
        """Sample + extract the request's subgraph and queue it."""
        with span("serve.sample", rid=req.rid, seeds=len(req.seeds)):
            t0 = time.perf_counter()
            nodes = sample_khop(self.csr, req.seeds, req.fanouts,
                                seed=req.sample_seed)
            sub = extract_subgraph(self.csr, nodes)
            seed_local = np.searchsorted(
                nodes, np.unique(np.asarray(req.seeds, np.int64)))
            sr = SampledRequest(req, nodes, sub, seed_local, t_submit=t0)
            _metrics.counter("serve_requests_total").inc(model=self.model)
        self.batcher.add(sr)
        return sr

    # ------------------------------------------------------------- serve
    def tick(self) -> list:
        """Drain the queue and serve every pending batch."""
        results = []
        for members in self.batcher.drain():
            results.extend(self._run_batch(members))
        return results

    def _run_batch(self, members) -> list:
        n_tot = sum(sr.n for sr in members)
        union = _union_csr(members)
        e_tot = int(union.indices.size)
        bucket = self.policy.pick(n_tot, e_tot)
        with span("serve.batch", bucket=bucket.key, requests=len(members),
                  nodes=n_tot, edges=e_tot):
            with span("serve.pack", bucket=bucket.key):
                t0 = time.perf_counter()
                pack = self.cache.get(bucket, union)
                padded = pack_subgraph(union, pack.geom)
                _metrics.histogram("serve_pack_seconds").observe(
                    time.perf_counter() - t0, bucket=bucket.key)
            X = self.features[np.concatenate([sr.nodes for sr in members])]
            with span("serve.forward", bucket=bucket.key):
                program = self._programs.get(pack.geom)
                if program is None:
                    program = self._programs[pack.geom] = BucketProgram(
                        pack.geom, padded, self.params,
                        self.features.shape[1], self.device,
                        model=self.model, graphs=self.graphs,
                        pool=self._pool)
                out = program(padded, X).cpu().numpy()
        now = time.perf_counter()
        results, off = [], 0
        for sr in members:
            rows = off + sr.seed_local
            results.append(RequestResult(
                rid=sr.req.rid, outputs=out[rows], bucket_key=bucket.key,
                latency_s=now - sr.t_submit, config=pack.config,
                sampled=sr if self.keep_subgraphs else None))
            off += sr.n
        self.batch_log.append((bucket.key,
                               tuple(sr.req.rid for sr in members)))
        self.requests_served += len(members)
        return results

    @property
    def compiled_buckets(self) -> int:
        """Bucket programs this service holds, one per geometry its
        batches used (the model is the service's): on a card with graphs,
        its CUDA-graph captures."""
        return len(self._programs)


def replay(service: GNNService, stream, *, tick_every: int = 8) -> list:
    """Drive a request stream through the service deterministically:
    submit in arrival order, tick whenever ``tick_every`` requests are
    pending, drain at the end.  Returns results in completion order."""
    results = []
    for req in stream:
        service.submit(req)
        if len(service.batcher) >= tick_every:
            results.extend(service.tick())
    results.extend(service.tick())
    return results
