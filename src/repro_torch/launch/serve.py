"""Serving launcher: batched requests through the continuous-batching engine.

    python -m repro_torch.launch.serve --arch smollm-135m \\
        --num-requests 8 --max-new-tokens 16

Runs on the GPU (the kernels are built at the first launch); ``--device cpu``
runs the plain PyTorch path instead.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.serve import Engine, EngineConfig, Request

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda; raises if there is none")
    ap.add_argument("--dtype", choices=sorted(_DTYPES), default="float32")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    dtype = _DTYPES[args.dtype]
    cfg = get_config(args.arch, reduced=args.reduced)
    gen = torch.Generator(device="cpu").manual_seed(args.seed)
    model = get_model(cfg)(cfg, dtype=dtype, device=device, generator=gen)
    engine = Engine(cfg, model,
                    EngineConfig(max_batch=args.max_batch,
                                 max_seq=args.max_seq, seed=args.seed),
                    dtype=dtype, device=device)
    rs = np.random.RandomState(args.seed)
    t0 = time.monotonic()
    for i in range(args.num_requests):
        plen = int(rs.randint(4, 24))
        prompt = rs.randint(0, cfg.vocab_size, size=plen).astype(np.int32)
        engine.submit(Request(uid=i, prompt=prompt,
                              max_new_tokens=args.max_new_tokens))
    done = engine.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    total_tokens = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:.1f} tok/s) on {device}")
    for r in sorted(done, key=lambda r: r.uid)[:4]:
        print(f"  req {r.uid}: prompt[:4]={list(r.prompt[:4])} "
              f"out[:8]={r.out_tokens[:8]}")


if __name__ == "__main__":
    main()
