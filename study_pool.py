"""Where ``run_study``'s process pool pays: the port's case studies run
serially and on a ``fork`` pool, both on the CPU.

    PYTHONPATH=src python3 study_pool.py [--processes N] [--repeats R]

Each study runs once each way untimed, then ``R`` times serial and pooled
in turn; one JSON line a study gives its cells, the pool's chunks and
workers (``study.pool_plan``), the median wall ms of each, the pool's
speedup and whether the records are equal as text. The fig15 transformer
study is the one the JAX package's ``benchmarks/run.py --processes`` times.
A line before them gives the median ms of a pool that runs nothing (its
forks and its close); the last line sums the studies. Needs no card and imports no JAX.
"""

import argparse
import json
import multiprocessing
import os
import statistics
import subprocess
import time

import torch

from repro_torch.configs import ShapeConfig, get_config, get_dlrm_config
from repro_torch.core import dse, study
from repro_torch.core.cluster import BASELINE_DGX_A100
from repro_torch.core.study import run_study


def _studies():
    cfg = get_config("transformer-1t")
    shape = ShapeConfig("paper", 2048, 1024, "train")
    fig15, fig15_dlrm = dse.cluster_comparison_studies(
        cfg, shape, get_dlrm_config(), 65536)
    return [("fig15-transformer", fig15), ("fig15-dlrm", fig15_dlrm),
            ("fig8-mpdp", dse.mpdp_study(cfg, shape, BASELINE_DGX_A100)),
            ("hetero-cost", dse.hetero_cost_study(cfg, shape)),
            ("placement", dse.placement_study()),
            ("pp-ep", dse.pp_ep_study()),
            ("pp-ep-table3", dse.pp_ep_study(
                clusters=tuple(dse.TABLE_III_CLUSTERS))),
            ("multi-tenant", dse.multi_tenant_study())]


def _text(result) -> str:
    return json.dumps(result.records, default=str)


def _timed(spec, processes):
    t0 = time.perf_counter()
    result = run_study(spec, processes=processes, device="cpu",
                       validate="off")
    return (time.perf_counter() - t0) * 1e3, result


def _pool_ms(processes: int) -> float:
    """Wall ms of a pool as ``run_study`` makes it (``fork``, one thread a
    worker) that runs a no-op on each worker and closes: the pool's fixed
    cost on this host."""
    t0 = time.perf_counter()
    with multiprocessing.get_context("fork").Pool(
            processes, initializer=torch.set_num_threads,
            initargs=(1,)) as pool:
        pool.map(abs, range(processes))
    return (time.perf_counter() - t0) * 1e3


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "no card"
    except (OSError, subprocess.SubprocessError):
        return "no card"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--processes", type=int,
                    default=min(8, os.cpu_count() or 1))
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    print(json.dumps({"host": {"cpu_count": os.cpu_count(),
                               "torch_threads": torch.get_num_threads(),
                               "torch": torch.__version__,
                               "card": _card()}}), flush=True)
    print(json.dumps({"empty_pool_ms": statistics.median(
        _pool_ms(args.processes) for _ in range(args.repeats)),
        "processes": args.processes}), flush=True)
    total = {"serial_ms": 0.0, "pool_ms": 0.0, "all_equal": True}
    for name, spec in _studies():
        chunks, workers = study.pool_plan(spec, study._cells(spec),
                                          args.processes)
        _, serial = _timed(spec, None)
        _, pooled = _timed(spec, args.processes)
        equal = _text(serial) == _text(pooled)
        serial_ms, pool_ms = [], []
        for _ in range(args.repeats):
            serial_ms.append(_timed(spec, None)[0])
            pool_ms.append(_timed(spec, args.processes)[0])
        row = {"study": name, "cells": len(serial), "chunks": len(chunks),
               "workers": workers, "processes": args.processes,
               "serial_ms": statistics.median(serial_ms),
               "pool_ms": statistics.median(pool_ms),
               "records_equal": equal}
        row["speedup"] = row["serial_ms"] / row["pool_ms"]
        total["serial_ms"] += row["serial_ms"]
        total["pool_ms"] += row["pool_ms"]
        total["all_equal"] &= equal
        print(json.dumps(row), flush=True)
    total["speedup"] = total["serial_ms"] / total["pool_ms"]
    print(json.dumps({"total": total}), flush=True)


if __name__ == "__main__":
    main()
