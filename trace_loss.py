"""Counts how often torch.profiler loses kernel events in the traces that
``chip_smoke.py``'s ``trace_ms`` takes: the attention backward at the four
smaller shapes of ``chip_smoke.py``'s backward cases, in fp32 and bf16,
each traced ``TRACES`` times over 10 calls with no retry. A trace lost
events when it counts other than ``10 x`` the plan's kernels.

    python3 trace_loss.py [TRACES]

Prints one JSON line per case: the plan's kernels a call, the traces taken,
how many lost events, and the first few of those (seconds since the first
trace, launches counted, launches per call of each kernel by name), so that
a burst shows as consecutive times. Needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import json
import sys
import time

import torch

import chip_smoke as cs

SHAPES = (("chatglm3-like d=128", 1, 32, 2, 1024, 128, True),
          ("ragged s=37", 1, 4, 4, 37, 64, True),
          ("non-causal s=130", 2, 6, 2, 130, 64, False),
          ("reduced d=16", 8, 4, 2, 128, 16, True))
CALLS = 10


def main() -> int:
    from torch.profiler import ProfilerActivity, profile
    traces = int(sys.argv[1]) if len(sys.argv) > 1 else 80
    if not torch.cuda.is_available():
        raise SystemExit("trace_loss: needs a CUDA device")
    cs.phase_build()
    gen = torch.Generator(device="cuda").manual_seed(4)
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, h, hkv, s, d, causal in SHAPES:
            def draw(heads):
                return torch.randn((b, s, heads, d), generator=gen,
                                   device="cuda").to(dtype).transpose(1, 2)
            q, k, v, do = draw(h), draw(hkv), draw(hkv), draw(h)
            o, lse = cs.flash_attention_lse_cuda(q, k, v, causal)

            def call():
                cs.flash_attention_backward_cuda(q, k, v, o, lse, do, causal)
            call()
            call()
            torch.cuda.synchronize()
            plan = cs.flash_attention_backward_plan(b, h, hkv, s, d)[1]
            lossy = []
            for _ in range(traces):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(CALLS):
                        call()
                    torch.cuda.synchronize()
                _, launches, by_name = cs._device_time(prof, CALLS, "call")
                if launches != CALLS * plan:
                    lossy.append({
                        "t_s": round(time.perf_counter() - t0, 3),
                        "launches": launches,
                        "by_name": {e["name"]: e["launches_per_call"]
                                    for e in by_name}})
            print(json.dumps({"case": name, "dtype": cs.dtype_name(dtype),
                              "plan_kernels_per_call": plan,
                              "traces": traces, "lost_events": len(lossy),
                              "lossy": lossy[:6]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
