"""Serving example on the PyTorch/CUDA port: batched requests through the
continuous-batching engine.

Counterpart of ``examples/serve_lm.py``: the reduced smollm, mixed prompt
lengths, staggered admission (ten requests through four slots), greedy
decoding, and a self-check that multi-slot batching reproduces
single-request decoding exactly. Runs on the GPU (the kernels are built at
the first launch) and raises without one; ``--device cpu`` runs the plain
PyTorch path instead.

Run: PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.serve import Engine, EngineConfig, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: cuda; raises if there is none")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config("smollm-135m", reduced=True)
    model = get_model(cfg)(cfg, dtype=torch.float32, device=device,
                           generator=torch.Generator().manual_seed(0))

    def engine(max_batch):
        return Engine(cfg, model, EngineConfig(max_batch=max_batch,
                                               max_seq=96),
                      dtype=torch.float32, device=device)

    batched = engine(4)
    rs = np.random.RandomState(0)
    t0 = time.monotonic()
    for i in range(10):
        plen = int(rs.randint(3, 20))
        batched.submit(Request(uid=i,
                               prompt=rs.randint(0, cfg.vocab_size, plen),
                               max_new_tokens=12))
    done = batched.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    tok = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests / {tok} tokens in {dt:.2f}s "
          f"({tok/dt:.0f} tok/s on {device})")

    # self-check: slot batching == single-request decode, every request
    for req in sorted(done, key=lambda r: r.uid):
        solo = engine(1)
        solo.submit(Request(uid=req.uid, prompt=req.prompt,
                            max_new_tokens=12))
        want = solo.run_until_drained()[0].out_tokens
        assert req.out_tokens == want, (
            f"request {req.uid}: batched decode {req.out_tokens} must match "
            f"solo decode {want}")
    print("batched == solo decode: OK")
    return done


if __name__ == "__main__":
    main()
