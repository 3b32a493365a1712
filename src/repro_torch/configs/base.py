"""Architecture configs of the LM side: ``ArchConfig`` (one model's
hyperparameter table, no weights) and the shape cells it is run at."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 → d_model // n_heads

    # attention details
    qkv_bias: bool = False
    rope_fraction: float = 1.0   # chatglm3 "2d RoPE" = rotary on half dims
    rope_base: float = 10000.0
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    norm_plus_one: bool = False  # gemma-style (1+w) scale
    act: str = "silu"            # silu | gelu  (gated MLP)
    attn_softcap: float = 0.0    # gemma2: 50.0
    logit_softcap: float = 0.0   # gemma2: 30.0
    sliding_window: int = 0      # gemma2 local layers / hymba SWA
    alternate_local_global: bool = False     # gemma2
    post_block_norm: bool = False            # gemma2 pre+post norms
    tie_embeddings: bool = True
    embed_scale: bool = False    # gemma-style sqrt(d) embedding scaling

    # MoE (granite)
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0

    # SSM (hymba mamba branch / rwkv)
    ssm_state: int = 0
    ssm_expand: int = 2
    n_global_layers: int = 0     # hymba: layers with full attention

    # enc-dec (whisper)
    n_enc_layers: int = 0

    # vlm (llava)
    n_patches: int = 0           # patch-embedding prefix length per sequence

    # which shape cells apply (long_500k only for sub-quadratic models)
    supports_long: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 128 (Megatron style); logits
        beyond ``vocab`` are masked at the decode boundary."""
        return -(-self.vocab // 128) * 128

    @property
    def kv_dim(self) -> int:
        return self.n_kv * self.head_dim

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeCell:
    """One input-shape cell: sequence length, global batch and kind."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long:
        out.append("long_500k")
    return out
