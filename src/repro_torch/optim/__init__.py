"""Optimisers of the port, as plain functions on parameter trees."""
from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .compression import topk_compress_apply, topk_compress_init

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "topk_compress_apply", "topk_compress_init"]
