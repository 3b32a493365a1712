"""hymba-1.5b [hybrid]: 32L d1600 25H (GQA kv=5, hd=64) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads [arXiv:2411.13676].
Sub-quadratic (SWA + SSM) → runs long_500k."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv=5, head_dim=64,
    d_ff=5504, vocab=32001,
    ssm_state=16, ssm_expand=2,
    sliding_window=1024, n_global_layers=3,
    supports_long=True,
)

REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    vocab=256, sliding_window=8, n_global_layers=1, ssm_state=4)
