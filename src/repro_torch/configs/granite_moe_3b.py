"""granite-moe-3b-a800m [moe]: 32L d1536 24H (GQA kv=8, hd=64) expert
d_ff=512 vocab=49155, MoE 40 experts top-8
[hf:ibm-granite/granite-3.0-3b-a800m-base]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv=8, head_dim=64,
    d_ff=512, vocab=49155,
    n_experts=40, top_k=8, expert_d_ff=512,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=64,
    vocab=256, n_experts=4, top_k=2, expert_d_ff=64)
