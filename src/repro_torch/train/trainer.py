"""Fault-tolerant training loop.

Counterpart of ``src/repro/train/trainer.py``:
  * checkpoint/restart — ``CheckpointManager`` cadence + auto-resume (the
    data iterator's cursor travels inside the checkpoint). The state is
    saved in the JAX package's layout (``convert.to_jax_train_state``), so
    either package resumes from the other's checkpoint. The layers are
    stacked on the host as they are saved and unstacked there as they are
    restored (``checkpoint.Stacked``): neither makes a second copy of the
    state on the device,
  * preemption — SIGTERM/SIGINT set a flag; the loop stops after the step
    it is in and writes one final forced checkpoint before it returns,
  * straggler mitigation — a per-step wall-time watchdog tracks a robust
    (median) step time; steps slower than ``straggler_factor`` x the median
    of the last 50 (once there are 10) are counted and surfaced, and an
    optional callback lets the launcher react,
  * metrics — one host read of a step's metrics (which waits for the step),
    logged and printed every ``log_interval`` steps and at the last.
"""

from __future__ import annotations

import dataclasses
import signal
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager, Stacked
from repro_torch.convert import to_jax_train_state
from repro_torch.data.pipeline import DataIterator


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_interval: int = 100
    ckpt_keep: int = 3
    log_interval: int = 10
    straggler_factor: float = 3.0
    seed: int = 0


def step_generator(seed: int, step: int,
                   device: torch.device) -> torch.Generator:
    """A step's own generator, seeded from the run's seed and the step (the
    reference folds the step into its key), so a step draws the same bits
    whatever ran before it."""
    return torch.Generator(device=device).manual_seed(
        hash((seed, step)) & 0x7FFF_FFFF_FFFF_FFFF)


class Trainer:
    def __init__(self, step_fn: Callable, state: dict, data: DataIterator,
                 cfg: TrainerConfig,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.step_fn = step_fn
        self.state = state
        self.data = data
        self.cfg = cfg
        self.on_straggler = on_straggler
        self.step = 0
        self.step_times: List[float] = []
        self.straggler_steps = 0
        self.metrics_log: List[Dict] = []
        self._preempted = False
        self.manager = (CheckpointManager(cfg.ckpt_dir, cfg.ckpt_interval,
                                          cfg.ckpt_keep)
                        if cfg.ckpt_dir else None)

    # ------------------------------------------------------------------ #
    def _install_signal_handlers(self) -> dict:
        """Install the preemption handlers; returns the ones they replace."""
        def handler(signum, frame):
            self._preempted = True
        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old = signal.signal(sig, handler)
            except ValueError:
                continue  # not on main thread (tests)
            if old is not None:      # None: installed outside Python
                previous[sig] = old
        return previous

    def try_resume(self) -> bool:
        """Restore the latest checkpoint into the state's own tensors, the
        step and the data cursor; False when there is none."""
        if self.manager is None or self.manager.latest_step() is None:
            return False
        _, extra = self.manager.restore_latest(
            target=to_jax_train_state(self.state, stack=Stacked))
        self.step = int(extra.get("step", 0))
        self.data.restore(extra.get("data", {"step": self.step}))
        return True

    # ------------------------------------------------------------------ #
    def _watchdog(self, dt: float) -> None:
        self.step_times.append(dt)
        window = self.step_times[-50:]
        if len(window) >= 10:
            med = statistics.median(window)
            if dt > self.cfg.straggler_factor * med:
                self.straggler_steps += 1
                if self.on_straggler is not None:
                    self.on_straggler(self.step, dt / med)

    def _checkpoint(self, force: bool = False) -> None:
        if self.manager is None:
            return
        extra = {"step": self.step, "data": self.data.state()}
        self.manager.maybe_save(self.step,
                                lambda: to_jax_train_state(self.state,
                                                           stack=Stacked),
                                extra, force=force)

    def _device(self) -> torch.device:
        return next(iter(self.state["params"].values())).device

    @staticmethod
    def _host(metrics: Dict) -> Dict[str, float]:
        """The step's metrics as floats, with one read from the device."""
        names = [k for k, v in metrics.items() if torch.is_tensor(v)]
        read = {}
        if names:
            stacked = torch.stack([metrics[k].detach().float().reshape(())
                                   for k in names])
            read = dict(zip(names, stacked.tolist()))
        return {k: read[k] if k in read else float(v)
                for k, v in metrics.items()}

    # ------------------------------------------------------------------ #
    def run(self, generator: Optional[torch.Generator] = None) -> Dict:
        """Train to ``total_steps`` (or a preemption signal). ``generator``:
        the run's seed (its ``initial_seed``); ``cfg.seed`` when None."""
        previous = self._install_signal_handlers()
        try:
            return self._run(generator)
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)

    def _run(self, generator: Optional[torch.Generator]) -> Dict:
        seed = self.cfg.seed if generator is None else generator.initial_seed()
        device = self._device()
        last_metrics: Dict = {}
        while self.step < self.cfg.total_steps and not self._preempted:
            batch = next(self.data)
            gen = step_generator(seed, self.step, device)
            t0 = time.monotonic()
            self.state, metrics = self.step_fn(self.state, batch, gen)
            metrics = self._host(metrics)
            dt = time.monotonic() - t0
            self._watchdog(dt)
            self.step += 1
            if self.step % self.cfg.log_interval == 0 or \
                    self.step == self.cfg.total_steps:
                row = {"step": self.step, "time_s": dt, **metrics}
                self.metrics_log.append(row)
                print(" ".join(
                    f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in row.items()), flush=True)
            last_metrics = metrics
            self._checkpoint()
        # final / preemption flush
        self._checkpoint(force=True)
        if self.manager:
            self.manager.wait()
        return {
            "final_step": self.step,
            "preempted": self._preempted,
            "straggler_steps": self.straggler_steps,
            "median_step_s": (statistics.median(self.step_times)
                              if self.step_times else 0.0),
            **{f"final_{k}": v for k, v in last_metrics.items()},
        }
