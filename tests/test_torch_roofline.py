"""PyTorch port vs JAX reference: ``launch/roofline.py``'s model-FLOP
arithmetic (``param_count``, ``model_flops_for``) on every LM config,
full size (nothing allocated), and the reference's own
accounting test mirrored."""
import pytest

from repro import configs as rconfigs
from repro.launch import roofline as rroof

from repro_torch import configs as tconfigs
from repro_torch.configs.base import SHAPES
from repro_torch.launch import roofline as troof


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_count_and_model_flops_equal_reference(arch):
    cfg, rcfg = tconfigs.get_config(arch), rconfigs.get_config(arch)
    assert troof.param_count(cfg) == rroof.param_count(rcfg)
    for cell in SHAPES.values():
        assert troof.model_flops_for(cfg, cell) == rroof.model_flops_for(
            rcfg, rconfigs.SHAPES[cell.name])


def test_model_flops_accounting():
    """``tests/test_launch_units.py::test_model_flops_accounting``."""
    cfg = tconfigs.get_config("qwen2-72b")
    total, active = troof.param_count(cfg)
    assert 70e9 < total < 76e9            # ≈72B
    t2, a2 = troof.param_count(tconfigs.get_config("granite-moe-1b-a400m"))
    assert a2 < t2                        # MoE active < total
    mf = troof.model_flops_for(cfg, SHAPES["train_4k"])
    assert abs(mf / (6 * active * 4096 * 256) - 1) < 1e-6


@pytest.mark.parametrize("arch,total_b,active_b", [
    ("chatglm3-6b", 5.98, 5.98), ("llava-next-mistral-7b", 7.11, 7.11),
    ("gemma2-27b", 27.23, 27.23), ("granite-moe-3b-a800m", 3.30, 0.88),
    ("granite-moe-1b-a400m", 1.33, 0.43), ("qwen2-72b", 72.7, 72.7),
    ("qwen1.5-110b", 111.2, 111.2), ("rwkv6-1.6b", 1.45, 1.45),
    ("whisper-tiny", 0.09, 0.09)])
def test_param_counts_of_the_full_configs(arch, total_b, active_b):
    """The sizes that decide what fits one 80 GB card (bf16: 2 bytes a
    parameter)."""
    total, active = troof.param_count(tconfigs.get_config(arch))
    assert round(total / 1e9, 1 if total > 5e10 else 2) == total_b
    assert round(active / 1e9, 1 if active > 5e10 else 2) == active_b


@pytest.mark.parametrize("arch,total", [("rwkv6-1.6b", 1_449_779_200),
                                        ("whisper-tiny", 86_848_512)])
def test_rwkv_and_whisper_param_counts_are_exact(arch, total):
    """Whisper's count holds its two 65,536-row position tables (50.3M of
    its 86.8M), as the reference's does."""
    assert troof.param_count(tconfigs.get_config(arch)) == (total, total)
