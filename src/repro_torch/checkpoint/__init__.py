"""Checkpoints of training state: atomic publish, async writer, retention,
restart from the latest."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
