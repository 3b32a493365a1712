"""gemma2-27b [dense]: 46L d4608 32H (GQA kv=16, hd=128) d_ff=36864
vocab=256000 — local/global alternating attention, attn softcap 50,
logit softcap 30, pre+post norms, (1+w) RMSNorm [arXiv:2408.00118]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv=16, head_dim=128,
    d_ff=36864, vocab=256000,
    act="gelu", attn_softcap=50.0, logit_softcap=30.0,
    sliding_window=4096, alternate_local_global=True,
    post_block_norm=True, norm_plus_one=True, embed_scale=True,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    vocab=256, sliding_window=8)
