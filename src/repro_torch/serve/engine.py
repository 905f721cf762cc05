"""Batched serving engine: continuous-batching prefill/decode loop.

Counterpart of ``src/repro/serve/engine.py``, same schedule and the same
tokens under greedy sampling. Requests enter a queue; the engine packs up to
``max_batch`` active sequences into one static decode batch (slots). Each
tick runs one ``decode_step`` over all slots; finished sequences (EOS or
length cap) free their slot, and queued requests are prefilled into free
slots.

Where it departs from the functional reference, on purpose:
  * the batched cache (dense: KV; mamba2: conv and ssm state; zamba2: both,
    the shared block's KV too) is updated in place. A request is prefilled straight into its slot's rows of the cache
    (a view), where the reference fills a fresh single-sequence cache and
    splices a copy of the whole batch;
  * a tick moves the sampled tokens to the host once (one ``tolist``), not
    once per slot: on the GPU each read is a synchronisation;
  * sampling at ``temperature > 0`` draws from a ``torch.Generator``; its
    stream is not ``jax.random``'s, so only the greedy outputs agree token
    for token.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (prompt_len,) integer
    max_new_tokens: int = 32
    temperature: float = 0.0           # 0 -> greedy
    out_tokens: Optional[List[int]] = None


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    max_seq: int = 512
    eos_id: int = -1                   # -1: never stops early
    seed: int = 0


class Engine:
    """``model``: a built model of ``cfg``'s family (the port's counterpart
    of the reference's ``params``) but the encoder-decoder, which needs
    frames; ``dtype``: the cache's type (mamba2's and zamba2's ssm state is
    fp32 whatever it is).
    ``device``: the GPU unless the caller asks for another; with no GPU and
    no request this raises. The model must lie on that device."""

    def __init__(self, cfg: ModelConfig, model: torch.nn.Module,
                 ecfg: EngineConfig, dtype: torch.dtype = torch.float32,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        if cfg.family == "encdec":
            raise ValueError(
                f"{cfg.arch_id}: the engine takes token prompts only, and an "
                "encoder-decoder needs its source frames (the reference's "
                "engine has no frames input either); call the model's "
                "prefill(tokens, cache, frames) and decode_step instead")
        if not isinstance(model, get_model(cfg)):
            raise TypeError(
                f"model is a {type(model).__name__}, not the "
                f"{get_model(cfg).__name__} that {cfg.arch_id} builds")
        if model.device.type != self.device.type or (
                self.device.index is not None
                and model.device.index != self.device.index):
            raise ValueError(
                f"model lies on {model.device}, engine on {self.device}")
        self.model = model
        self.ecfg = ecfg
        self.dtype = dtype
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}       # slot -> request
        self.remaining: Dict[int, int] = {}
        self.temps: Dict[int, float] = {}          # slot -> temperature
        self.cache = model.init_cache(ecfg.max_batch, ecfg.max_seq,
                                      dtype=dtype)
        self.last_tokens = torch.zeros((ecfg.max_batch, 1), dtype=torch.long,
                                       device=self.device)
        self._rng = torch.Generator(device=self.device).manual_seed(ecfg.seed)

    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> None:
        total = len(req.prompt) + req.max_new_tokens
        if total > self.ecfg.max_seq:
            raise ValueError(
                f"request {req.uid}: prompt_len ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) = {total} exceeds "
                f"max_seq ({self.ecfg.max_seq}); the decode cache would "
                "overflow mid-generation")
        req.out_tokens = []
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i in range(self.ecfg.max_batch) if i not in self.active]

    def _admit(self) -> None:
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.popleft()
            prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.long,
                                     device=self.device)[None, :]
            # A view of this slot's entry of every cache tensor (the batch
            # axis is 1 in both layouts): the prefill writes the batched cache
            # in place. Dense: rows past the prompt keep the last owner's K/V,
            # which the causal mask hides until they are overwritten. Mamba2:
            # the prefill overwrites the slot's conv and ssm state and never
            # starts from them.
            slot_cache = {
                name: t[:, slot:slot + 1]
                for name, t in self.cache.items() if name != "pos"}
            slot_cache["pos"] = torch.zeros((1,), dtype=torch.int32,
                                            device=self.device)
            logits, slot_cache = self.model.prefill(prompt, slot_cache)
            self.cache["pos"][slot] = slot_cache["pos"][0]
            tok = self._sample(logits[:, -1, :], req.temperature)
            self.last_tokens[slot, 0] = tok[0]
            req.out_tokens.append(int(tok[0]))
            self.active[slot] = req
            self.remaining[slot] = req.max_new_tokens - 1
            self.temps[slot] = req.temperature

    def _sample(self, logits: torch.Tensor,
                temperature: float) -> torch.Tensor:
        if temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._rng)[:, 0]

    def _sample_slots(self, logits: torch.Tensor) -> torch.Tensor:
        """Per-slot decode sampling: greedy for slots at temperature <= 0,
        categorical at each slot's own temperature otherwise.  The RNG
        only advances when some active slot actually samples, so
        all-greedy batches stay bit-for-bit reproducible."""
        greedy = torch.argmax(logits, dim=-1)
        temps = np.zeros((self.ecfg.max_batch,), np.float32)
        for slot, t in self.temps.items():
            if t > 0:
                temps[slot] = t
        if not temps.any():
            return greedy
        hot = torch.as_tensor(temps > 0, device=self.device)
        safe = torch.as_tensor(np.where(temps > 0, temps, 1.0),
                               device=self.device)
        probs = torch.softmax(logits.float() / safe[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self._rng)[:, 0]
        return torch.where(hot, sampled, greedy)

    # ------------------------------------------------------------------ #
    def tick(self) -> List[Request]:
        """One engine step. Returns requests completed this tick."""
        self._admit()
        done: List[Request] = []
        if not self.active:
            return done
        logits, self.cache = self.model.decode_step(self.cache,
                                                    self.last_tokens)
        next_tokens = self._sample_slots(logits[:, 0, :])
        self.last_tokens = next_tokens[:, None]
        host_tokens = next_tokens.tolist()      # the tick's one device read
        for slot in list(self.active):
            req = self.active[slot]
            tok = host_tokens[slot]
            req.out_tokens.append(tok)
            self.remaining[slot] -= 1
            if tok == self.ecfg.eos_id or self.remaining[slot] <= 0:
                done.append(req)
                del self.active[slot]
                del self.remaining[slot]
                del self.temps[slot]
        return done

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        out: List[Request] = []
        for _ in range(max_ticks):
            out.extend(self.tick())
            if not self.active and not self.queue:
                break
        return out
