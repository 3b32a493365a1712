"""The LM launchers on the decoder-only families (dense qwen2 / qwen1.5 /
chatglm3 / gemma2, VLM llava-next, MoE granite), reduced, on the CPU:
``launch/train.py`` (llava's batches carry their patches) with falling
losses, and ``launch/serve.py``'s greedy decode, batch 4 (the reference
CLI's default).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeCell
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm

from test_torch_lm_dense import ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_every_family(arch, capsys):
    losses = ttrain.train(["--arch", arch, "--reduced", "--device", "cpu",
                           "--steps", "5", "--batch", "2", "--seq", "16",
                           "--log-every", "4"])
    assert len(losses) == 5 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "done: loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_every_family(arch, capsys):
    seq = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--prompt-len", "4", "--gen", "6"])
    assert tuple(seq.shape) == (4, 10)
    assert int(seq.max()) < ttrain.get_reduced(arch).vocab
    assert "generated (4, 10) on cpu" in capsys.readouterr().out


def test_vlm_batches_carry_their_patches():
    cfg = ttrain.get_reduced("llava-next-mistral-7b")
    batch = ttrain.device_batch(cfg, 2, 16, 0, 0, "cpu")
    assert tuple(batch["patches"].shape) == (2, cfg.n_patches, cfg.d_model)
    assert batch["patches"].dtype == torch.float32
    h = tlm.forward_hidden(tlm.init_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
        cfg, batch)
    assert tuple(h.shape) == (2, 16, cfg.d_model)
    specs = tlm.input_specs(cfg, ShapeCell("t", 24, 2, "train"))
    assert specs["tokens"][0] == (2, 24 - cfg.n_patches)
