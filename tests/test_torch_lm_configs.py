"""PyTorch port vs JAX reference: the LM configs of every id (hybrid,
dense, MoE, VLM, RWKV6, Whisper), their parameter shapes and data.

The config tables equal the reference's field for field, full and
reduced, with their derived properties and shape cells.  ``model_defs``
of the FULL configs (qwen2-72b and qwen1.5-110b do not fit one card) are
compared as shapes and roles, with nothing allocated.  RWKV6's and
Whisper's input specs equal the reference's at every cell, and a family
neither package has raises the reference's ``ValueError``.  The token
pipeline's llava batches (patches drawn after the tokens) are
array-equal to the reference's.
"""
import dataclasses

import numpy as np
import pytest

from repro import configs as rconfigs
from repro.configs import base as rbase
from repro.data import tokens as rtokens
from repro.models import lm as rlm

from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.data import tokens as ttokens
from repro_torch.models import lm as tlm


def _defs(defs, path=()):
    """{path: (shape, role)} of a defs tree (the reference's tuples)."""
    if isinstance(defs, dict):
        out = {}
        for k in sorted(defs):
            out.update(_defs(defs[k], path + (k,)))
        return out
    return {"/".join(path): (tuple(defs[0]), defs[1])}


def test_port_runs_every_reference_lm():
    assert tconfigs.ARCH_IDS == rconfigs.ARCH_IDS


@pytest.mark.parametrize("which", ["get_config", "get_reduced"])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_config_tables_equal_reference(arch, which):
    r, t = getattr(rconfigs, which)(arch), getattr(tconfigs, which)(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    for prop in ("q_dim", "kv_dim", "vocab_padded"):
        assert getattr(t, prop) == getattr(r, prop)
    assert tbase.applicable_shapes(t) == rbase.applicable_shapes(r)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_full_model_defs_equal_reference(arch):
    cfg = tconfigs.get_config(arch)
    got = _defs(tlm.model_defs(cfg))
    want = _defs(rlm.model_defs(rconfigs.get_config(arch)))
    assert got == want
    assert ("lm_head" in got) == (not cfg.tie_embeddings)
    assert ("layers/bq" in got) == cfg.qkv_bias
    assert ("layers/ln1_post/w" in got) == cfg.post_block_norm
    if cfg.n_experts:
        assert got["layers/ewd"][0] == (cfg.n_layers, cfg.n_experts,
                                        cfg.expert_d_ff, cfg.d_model)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (1, 7), (3, 123)])
def test_vlm_batch_for_step_equals_reference(seed, step):
    cfg = rconfigs.get_reduced("llava-next-mistral-7b")
    want = rtokens.batch_for_step(cfg, 4, 16, step, seed)
    got = ttokens.batch_for_step(tconfigs.get_reduced(
        "llava-next-mistral-7b"), 4, 16, step, seed)
    assert sorted(got) == sorted(want) == ["labels", "patches", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["patches"].shape == (4, cfg.n_patches, cfg.d_model)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "whisper-tiny"])
def test_ssm_and_encdec_input_specs_equal_reference(arch):
    """An ``ssm`` and an ``encdec`` cell of every kind: Whisper's frames
    (B, S, D) bf16 with max(128, S // 4) tokens, RWKV's tokens."""
    for name, cell in rbase.SHAPES.items():
        want = rlm.input_specs(rconfigs.get_config(arch), cell)
        got = tlm.input_specs(tconfigs.get_config(arch),
                              tbase.SHAPES[name])
        assert {k: (v[0], str(v[1]).split(".")[-1]) for k, v in got.items()} \
            == {k: (tuple(v.shape), v.dtype.name) for k, v in want.items()}


def test_unknown_family_raises_the_reference_error():
    """``ValueError(family)`` from ``model_defs`` and ``cache_specs`` of
    both packages (the port's other entry points check it first too)."""
    for cfgs, lm, shapes in ((rconfigs, rlm, rbase.SHAPES),
                             (tconfigs, tlm, tbase.SHAPES)):
        cfg = cfgs.get_reduced("rwkv6-1.6b").replace(family="nope")
        with pytest.raises(ValueError, match="nope"):
            lm.model_defs(cfg)
        with pytest.raises(ValueError, match="nope"):
            lm.cache_specs(cfg, shapes["train_4k"])
