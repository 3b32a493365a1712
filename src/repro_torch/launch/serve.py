"""Serving launcher: batched decode with a KV cache (teacher-forced
prompt, then greedy or temperature sampling).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      [--reduced] [--batch 4 --prompt-len 16 --gen 32] [--device cpu]

``--arch`` takes every LM id of ``configs.ARCH_IDS``: the hybrid,
dense, MoE, VLM, RWKV6 and Whisper families (Whisper's cross-attention
cache stays zeros, as in the reference).  Runs on CUDA unless ``--device``
names another device.  On a card the
decode step is captured once as a CUDA graph and replayed, where the
reference jits it (``repro/launch/serve.py``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.device import resolve_device
from repro_torch.kernels.capture import capture
from repro_torch.models import lm


def generate(cfg, params, prompt, max_len: int, gen: int, *,
             temperature=0.0, seed=0, device=None, graphs=None):
    """Greedy/temperature decode of ``gen`` tokens after teacher-forcing
    the prompt (B, P) through ``decode_step`` (the cache path end to end).
    Returns the (B, P + gen) tokens.  Temperature samples draw from a
    ``torch.Generator`` seeded with ``seed`` on the device.

    With ``graphs`` (the default on a card) the step runs over static
    token, position, cache and logits tensors: the first step eagerly on
    a side stream (the warm-up), then captured once as a CUDA graph and
    replayed for every later step (``kernels.capture``).  Teacher forcing
    and sampling stay outside the graph, as the reference jits only the
    step.  ``graphs=False`` runs every step eagerly."""
    device = resolve_device(device)
    if graphs is None:
        graphs = device.type == "cuda"
    if graphs and device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
    prompt = torch.as_tensor(prompt, dtype=torch.int64, device=device)
    B, P = prompt.shape
    cache = lm.init_cache(cfg, ShapeCell("serve", max_len, B, "decode"),
                          device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    tok = prompt[:, :1]
    out = [tok]
    static_tok = tok.clone()
    static_pos = torch.zeros((), dtype=torch.int64, device=device)
    step = lambda: lm.decode_step(params, cfg, static_tok, cache,
                                  static_pos)[0]
    captured = None
    with torch.no_grad():
        for pos in range(P + gen - 1):
            if not graphs:
                logits, cache = lm.decode_step(params, cfg, tok, cache, pos)
            else:
                static_tok.copy_(tok)
                static_pos.fill_(pos)
                if captured is None:
                    logits, captured = capture(step, device)
                else:
                    logits = captured.replay()
            if pos + 1 < P:
                tok = prompt[:, pos + 1:pos + 2]          # teacher forcing
            elif temperature > 0:
                probs = torch.softmax(logits[:, -1] / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)
            else:
                tok = logits[:, -1].argmax(-1)[:, None]
            out.append(tok)
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    params = lm.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    t0 = time.perf_counter()
    seq = generate(cfg, params, prompt, args.prompt_len + args.gen,
                   args.gen, temperature=args.temperature, seed=args.seed,
                   device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    n_tok = args.batch * (args.prompt_len + args.gen)
    print(f"generated {tuple(seq.shape)} on {device} in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s incl. warmup)")
    print("sample:", seq[0, :24].tolist())
    return seq


if __name__ == "__main__":
    main()
