"""LM training launcher with checkpoint/restart fault tolerance.

  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
      [--reduced] [--steps 100 --batch 8 --seq 64] [--ckpt-dir DIR \
      --resume] [--compress 0.05] [--device cpu]

``--arch`` takes every LM id of ``configs.ARCH_IDS`` (hybrid, dense,
MoE, VLM, RWKV6, Whisper); a VLM's batches carry their patch embeddings,
Whisper's its stub audio frames (``device_batch``).  Runs on CUDA
unless ``--device`` names another device.  Each step is the reference's
(``repro/launch/train.py``): the gradient of ``lm.train_loss`` (remat on,
attention chunk 256), optional top-k compression with error feedback,
AdamW with global-norm clipping at 1.0.  Parameters and their gradients
are bf16 (``a_log`` float32), the AdamW state float32; as the
reference's jitted step donates them, the launcher's step updates the
parameters and the state in place.  The data pipeline is stateless
(``data/tokens.py``), checkpoints publish atomically from an async
writer, ``--resume`` restarts from the latest, and SIGTERM checkpoints
and exits.  The reference's host mesh has no counterpart on one card.
"""
from __future__ import annotations

import argparse
import signal
import sys
import time

import torch

from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data.tokens import batch_for_step
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               topk_compress_apply, topk_compress_init)
from repro_torch.optim.adamw import tree_map


def build_step(cfg, opt_cfg, compress_frac=0.0, *, donate=False):
    """``step(params, opt_state, err, batch) → (params, opt_state, err,
    loss)``: new parameters, state and error memory; the inputs are left
    as they are, unless ``donate``: then the parameters and the AdamW
    state are updated in place, as the reference's step donates its
    inputs (``donate_argnums``), so a step holds one copy of them
    (granite-moe-3b's full config trains on one 80 GB card only so)."""
    def step_fn(params, opt_state, err, batch):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = lm.train_loss(p, cfg, batch, chunk=256)
        loss.backward()
        grads = tree_map(lambda t: t.grad, p)
        del p
        if compress_frac > 0:
            grads, err = topk_compress_apply(grads, err, compress_frac)
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg,
                                         inplace=donate)
        return params, opt_state, err, loss.detach()

    return step_fn


def device_batch(cfg, batch, seq, step, seed, device):
    """``batch_for_step``'s arrays (tokens, labels, and a VLM's patches or
    Whisper's frames) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device)
            for k, v in batch_for_step(cfg, batch, seq, step, seed).items()}


def train(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", type=float, default=0.0,
                    help="top-k gradient compression fraction (0=off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    opt_cfg = AdamWConfig(lr=args.lr, grad_clip=1.0)

    params = lm.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    opt_state = adamw_init(params)
    err = (topk_compress_init(params) if args.compress > 0
           else torch.zeros((), dtype=torch.float32, device=device))
    start_step = 0

    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if args.resume:
            s, tree = mgr.restore(device=device)
            if s is not None:
                params, opt_state, err = tree
                start_step = s + 1
                print(f"resumed from step {s}", flush=True)

    # graceful preemption: checkpoint on SIGTERM, then exit cleanly
    stop = {"now": False}

    def _sigterm(*_):
        stop["now"] = True

    previous = signal.signal(signal.SIGTERM, _sigterm)
    step_fn = build_step(cfg, opt_cfg, args.compress, donate=True)
    t0 = time.time()
    tokens_done = 0
    losses = []
    try:
        for step in range(start_step, args.steps):
            batch = device_batch(cfg, args.batch, args.seq, step, args.seed,
                                 device)
            with obs.span("train.step", step=step):
                params, opt_state, err, loss = step_fn(params, opt_state,
                                                       err, batch)
                losses.append(float(loss))
            tokens_done += args.batch * args.seq
            if step % args.log_every == 0 or step == args.steps - 1:
                dt = time.time() - t0
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"tok/s {tokens_done / max(dt, 1e-9):,.0f}", flush=True)
            if mgr and (step % args.ckpt_every == 0 or stop["now"]
                        or step == args.steps - 1):
                mgr.save(step, (params, opt_state, err))
            if stop["now"]:
                print(f"SIGTERM: checkpointed at step {step}, exiting",
                      flush=True)
                mgr and mgr.wait()
                sys.exit(0)
    finally:
        signal.signal(signal.SIGTERM, previous)
    mgr and mgr.wait()
    if losses:
        print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    return losses


main = train


if __name__ == "__main__":
    train()
