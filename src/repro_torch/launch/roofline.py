"""Model-FLOP arithmetic of the LM configs: parameter counts from the
model defs and the 6·N / 2·N rule per token.

The JAX package's ``launch/roofline.py`` also parses compiled XLA HLO
(cost analysis, collective bytes); those parsers have no counterpart
here.  ``chip_smoke.py`` states each LM run's model FLOPs with these two
functions, and their share of the card's dense bf16 peak."""
from __future__ import annotations

import math

from repro_torch.models import lm


def param_count(cfg) -> tuple[float, float]:
    """(total, active) parameter counts from ``lm.model_defs``: an MoE
    expert leaf (``layers/ew*``) counts ``top_k / n_experts`` of itself
    as active."""
    counts = [0, 0]

    def add(path, leaf):
        n = math.prod(leaf[0])
        counts[0] += n
        if path[0] in ("layers", "glayers") and path[1].startswith("ew"):
            n = n * cfg.top_k // max(1, cfg.n_experts)
        counts[1] += n

    lm.map_defs(add, lm.model_defs(cfg))
    return float(counts[0]), float(counts[1])


def model_flops_for(cfg, cell) -> float:
    """6·N_active·tokens for train; 2·N_active·tokens for prefill; one
    token a sequence for decode."""
    _, active = param_count(cfg)
    if cell.kind == "train":
        return 6.0 * active * cell.seq_len * cell.global_batch
    if cell.kind == "prefill":
        return 2.0 * active * cell.seq_len * cell.global_batch
    return 2.0 * active * cell.global_batch
