"""Training launcher, the port of `repro.launch.train`.

Drives a config end to end on one device (the card by default):

    python -m repro_torch.launch.train --arch granite-8b --reduced \
        --steps 200 --ckpt-dir /tmp/ckpt [--device cpu]

The flags are the reference's, plus `--device`. As there, `--reduced` is
a store_true flag whose default is True, so it cannot be switched off:
the launcher always trains the reduced config (full-width training runs
through the library functions: `training.train_step.make_train_step`
and `training.loop.run_training`).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import lm_batches
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.training.loop import LoopConfig, run_training
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_step import make_train_step


def to_device(batch, device):
    """A pipeline batch (numpy) as tensors on `device`: int64 tokens and
    labels, float32 embeds."""
    return {k: torch.from_numpy(v).to(device=device, dtype=(
        torch.float32 if k == "embeds" else torch.long))
        for k, v in batch.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"[train] {cfg.name}: {cfg.n_params / 1e6:.2f}M params, "
          f"{n_dev} device(s), on {dev}")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, lr=args.lr, remat=False)

    embeds_dim = cfg.d_model if cfg.frontend != "none" else None
    batches_iter = lm_batches(cfg.vocab_size, args.batch, args.seq,
                              embeds_dim=embeds_dim)

    def batch_stream():
        for b in batches_iter:
            yield to_device(b, dev)

    loop_cfg = LoopConfig(total_steps=args.steps,
                          ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir)
    params, opt, report = run_training(step_fn, params, opt, batch_stream(),
                                       loop_cfg)
    print(f"[train] ran {report.steps_run} steps "
          f"(resumed_from={report.resumed_from}); "
          f"loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f}; "
          f"stragglers={report.straggler_events} retries={report.retries}")
    return report


if __name__ == "__main__":
    main()
