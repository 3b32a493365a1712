"""llava-next-mistral-7b [vlm]: 32L d4096 32H (GQA kv=8) d_ff=14336
vocab=32000 — mistral backbone, anyres vision frontend STUB (input_specs
supplies patch embeddings) [hf:llava-hf/llava-v1.6-mistral-7b-hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=14336, vocab=32000,
    n_patches=1152,                 # anyres: base 576 + 576 tile pool
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    vocab=256, n_patches=8)
