"""End-to-end training driver on the PyTorch/CUDA port: a real LM trained
for a few hundred steps with checkpointing and the synthetic-but-learnable
pipeline.

Counterpart of ``examples/train_lm.py``. Defaults to the reduced smollm
config; pass ``--full`` for the real 135M configuration (same code path).
Runs on the GPU, through the attention and RMSNorm kernels in both
directions (built at the first launch), and raises without one;
``--device cpu`` runs the plain PyTorch path instead.

Run: PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--full]
"""

import argparse
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, DataIterator
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
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="default: cuda; raises if there is none")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config("smollm-135m", reduced=not args.full)
    plan = plan_memory(cfg, tp=1, dp=1)
    print(f"training {cfg.arch_id}: {cfg.param_count()/1e6:.1f}M params, "
          f"plan: zero-{plan.zero_stage} {plan.opt_dtype} remat={plan.remat} "
          f"on {device}")
    opt = AdamWConfig(lr=3e-3, warmup_steps=args.steps // 20,
                      total_steps=args.steps)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_train_state(cfg, plan, gen, opt, dtype=torch.float32,
                             device=device)
    step_fn = make_train_step(cfg, plan, opt)
    data = DataIterator(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=args.seq_len,
                                   global_batch=args.global_batch),
                        device=str(device))
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(step_fn, state, data, TrainerConfig(
            total_steps=args.steps, ckpt_dir=ckpt_dir, ckpt_interval=100,
            log_interval=20))
        summary = trainer.run(gen)
    print(f"\nfinal loss {summary['final_loss']:.3f} after "
          f"{summary['final_step']} steps "
          f"(median step {summary['median_step_s']*1e3:.0f} ms, "
          f"stragglers: {summary['straggler_steps']})")
    assert summary["final_loss"] < 7.0, "loss should drop on Markov data"
    return summary


if __name__ == "__main__":
    main()
