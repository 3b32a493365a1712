"""Optimisers of the port, as plain functions on parameter lists."""
from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]
