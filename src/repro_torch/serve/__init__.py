"""GNN inference serving tier of the PyTorch port.

Request path: seed node ids → seeded fanout-capped k-hop sampling →
induced-subgraph extraction with local relabeling → shape-bucket PCSR
pack (padded to the bucket ceiling) → GCN/GIN forward through the
ParamSpMM kernel with its fused epilogue, or GAT forward through the fused
SDDMM → softmax-stats kernel and the ParamSpMM softmax prologue — with dynamic request batching into fixed-geometry
shape buckets and a bucket-keyed cache amortizing the config pick.
"""
from .batcher import (RequestBatcher, SampledRequest, SubgraphRequest,
                      synthetic_stream)
from .bucket import (BucketPolicy, PackGeom, ShapeBucket, pack_subgraph,
                     steering_arrays)
from .cache import BucketPack, SteeringPackCache
from .forward import bucket_forward, reference_forward
from .service import GNNService, RequestResult, replay

__all__ = [
    "ShapeBucket", "BucketPolicy", "PackGeom", "pack_subgraph",
    "steering_arrays", "BucketPack", "SteeringPackCache",
    "SubgraphRequest", "SampledRequest", "RequestBatcher",
    "synthetic_stream", "bucket_forward", "reference_forward",
    "GNNService", "RequestResult", "replay",
]
