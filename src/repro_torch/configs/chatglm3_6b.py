"""chatglm3-6b [dense]: 28L d4096 32H (GQA kv=2) d_ff=13696 vocab=65024 —
2d (partial) RoPE, GQA, QKV bias [arXiv:2406.12793]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv=2, head_dim=128,
    d_ff=13696, vocab=65024,
    qkv_bias=True, rope_fraction=0.5,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    vocab=256)
