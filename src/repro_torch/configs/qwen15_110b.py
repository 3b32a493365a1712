"""qwen1.5-110b [dense]: 80L d8192 64H (GQA kv=8) d_ff=49152 vocab=152064
— QKV bias [hf:Qwen/Qwen1.5-110B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv=8, head_dim=128,
    d_ff=49152, vocab=152064,
    qkv_bias=True, tie_embeddings=False,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    vocab=256)
