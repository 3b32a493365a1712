"""whisper-tiny [audio]: 4L enc + 4L dec, d384 6H d_ff=1536 vocab=51865 —
enc-dec, conv frontend STUB (input_specs supplies frame embeddings)
[arXiv:2212.04356]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, n_enc_layers=4, d_model=384, n_heads=6, n_kv=6,
    head_dim=64, d_ff=1536, vocab=51865,
    norm="layernorm", act="gelu",
)

REDUCED = CONFIG.replace(
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=2, n_kv=2,
    head_dim=32, d_ff=128, vocab=256)
