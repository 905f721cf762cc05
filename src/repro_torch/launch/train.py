"""End-to-end training entry point.

    python -m repro_torch.launch.train --arch smollm-135m --steps 300 \\
        --global-batch 8 --seq-len 128 --ckpt-dir build/ckpt --resume auto

Counterpart of ``src/repro/launch/train.py``: fp32 parameters, the memory
plan for one device (``plan_memory(cfg, tp=1, dp=1)``), the reference's
AdamW settings, the port's data pipeline and trainer. Runs on the GPU,
through the kernels in both directions (attention and RMSNorm for the
transformers; the SSD scan and RMSNorm for mamba2, ``--arch mamba2-780m``;
all three for zamba2, ``--arch zamba2-2.7b``, whose shared block's
attention runs at head_dim 160; built at the first launch), and prints
their launches at the end;
``--device cpu`` runs the plain PyTorch path instead, and ``--reduced`` the
small same-family config. ``--ckpt-dir`` saves every ``--ckpt-interval`` steps and at the end
(or on SIGTERM/SIGINT) in the JAX package's checkpoint format; ``--resume
auto`` restores the latest checkpoint there, the data cursor included.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, DataIterator
from repro_torch.kernels import ops
from repro_torch.parallel import plan_memory
from repro_torch.train import (
    AdamWConfig,
    Trainer,
    TrainerConfig,
    init_train_state,
    make_train_step,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--resume", default="no", choices=["no", "auto"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda; raises if there is none")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    plan = plan_memory(cfg, tp=1, dp=1)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 1),
                          state_dtype=plan.opt_dtype,
                          use_master=plan.use_master)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_train_state(cfg, plan, gen, opt_cfg, dtype=torch.float32,
                             device=device)
    step_fn = make_train_step(cfg, plan, opt_cfg)
    data = DataIterator(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch, seed=args.seed), device=str(device))
    trainer = Trainer(step_fn, state, data, TrainerConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_interval=args.ckpt_interval, log_interval=10, seed=args.seed))
    print(f"plan: remat={plan.remat} microbatches={plan.microbatches} "
          f"opt={plan.opt_dtype} master={plan.use_master} on {device}",
          flush=True)
    if args.resume == "auto":
        resumed = trainer.try_resume()
        print("resume: " + (f"restored step {trainer.step}" if resumed
                            else "fresh start"), flush=True)
    summary = trainer.run(gen)
    print("summary:", summary)
    if device.type == "cuda":
        print("kernel launches:", kernel_launches(), flush=True)
    return summary


def kernel_launches() -> dict:
    """The training paths' kernel launches so far, each direction."""
    return {"flash_attention": ops.flash_attention.launches,
            "flash_attention_backward": ops.flash_attention.backward_launches,
            "rmsnorm": ops.rmsnorm.launches,
            "rmsnorm_backward": ops.rmsnorm.backward_launches,
            "ssd_scan": ops.ssd_scan.launches,
            "ssd_scan_backward": ops.ssd_scan.backward_launches}


if __name__ == "__main__":
    main()
