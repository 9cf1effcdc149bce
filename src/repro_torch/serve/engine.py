"""Continuous-batching serving engines: the counterparts of
``repro/serve/engine.py``'s ``ServingEngine`` and ``DictCacheEngine``.

A fixed pool of decode slots; requests are admitted when a slot frees and
the chip-scaled token budget allows, with the elasticity parameters the LM
profiles advertise (``chips``, ``context``, ``rung``), exactly as in the
JAX engines.

``ServingEngine``'s device-resident state: one stacked cache with a slot
axis after the layer axis and a ``(slots,)`` write cursor, updated in
place: ``(L, slots, max_seq, KH, D)`` keys and values for the decoder,
``(L, slots, K-1, C)`` conv and ``(L, slots, h, p, n)`` SSM states for a
Mamba-2 stack. JAX vmaps a batch-1 decode over the slot axis; the port
decodes all slots as ONE batch whose rows each carry their own position
and length (rope, cache write and the decode kernel are all per row). Finished slots free-run:
their lane keeps decoding, the host stops reading it, and a KV write
clamps to ``max_seq - 1`` so it never touches another lane. Where the
model takes padded prompts (``supports_padded_prefill``: the decoder)
they are right-padded to power-of-two buckets and prefilled with their
true length; a recurrent model prefills the exact length, as in JAX.

``DictCacheEngine`` is ``repro``'s seed-era baseline: a batch-1 cache per
slot in a dict, a prefill at the prompt's exact length, and one batch-1
decode plus one device-to-host copy per active slot each step. It is the
engine comparison's baseline and the stacked engine's parity oracle: on a
seeded float32 run both engines emit the same token streams.

``last_step_s`` / ``step_ewma_s`` are measured wall-clock per decode step,
ending in the step's device-to-host copies of the next tokens; ``step_s``
keeps the newest ``STEP_HISTORY`` of them, and ``admissions`` counts the
prompts prefilled (one prefill each).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import Model

MIN_BUCKET = 8          # smallest prefill bucket (tokens)
EWMA_ALPHA = 0.25       # step-latency smoothing for telemetry
STEP_HISTORY = 4096     # decode step times an engine keeps


def bucket_length(n: int, max_seq: int, minimum: int = MIN_BUCKET) -> int:
    """Next power-of-two prompt bucket >= n, clamped to the cache length."""
    b = minimum
    while b < n:
        b *= 2
    return min(b, max_seq)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                    # (S,) int32
    max_new_tokens: int = 16
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineConfig:
    slots: int = 4                 # decode batch size (fixed pool)
    max_seq: int = 256
    chips: float = 1.0             # elasticity: resource share
    context: int = 256             # elasticity: prompt budget (data quality)
    rung: int = 4                  # elasticity: model-size rung
    tokens_per_chip_step: int = 64 # admission budget per step per chip


class _EngineBase:
    """Shared host-side bookkeeping: queue, elasticity API, counters."""

    def __init__(self, model: Model, params, cfg: EngineConfig):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}     # slot -> request
        self.completed: List[Request] = []
        self.steps = 0
        self.tokens_out = 0
        self.prompt_tokens_in = 0                # admitted (post-truncation)
        self.admissions = 0                      # prompts prefilled
        self.last_step_s = 0.0                   # measured decode wall-clock
        self.step_ewma_s: Optional[float] = None
        self.step_s: collections.deque = collections.deque(
            maxlen=STEP_HISTORY)
        self.last_prefill_s = 0.0
        self.prefill_ewma_s: Optional[float] = None

    # -- elasticity API (what MUDAP's ScalingAPI calls) -----------------------
    def apply(self, param: str, value: float) -> None:
        if param == "chips":
            self.cfg.chips = float(value)
        elif param == "context":
            self.cfg.context = int(value)
        elif param == "rung":
            self.cfg.rung = int(value)
        else:
            raise KeyError(param)

    def metrics(self) -> Dict[str, float]:
        return {"queue": float(len(self.queue)),
                "active": float(len(self.active)),
                "steps": float(self.steps),
                "tokens_out": float(self.tokens_out),
                "step_latency_ms": 1e3 * (self.step_ewma_s or
                                          self.last_step_s),
                "chips": self.cfg.chips, "context": float(self.cfg.context),
                "rung": float(self.cfg.rung)}

    # -- request flow ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _truncate(self, req: Request) -> np.ndarray:
        """Keep the newest ``context`` prompt tokens (and never more than the
        cache can hold)."""
        keep = min(len(req.prompt), self.cfg.context, self.cfg.max_seq)
        return req.prompt[-keep:]

    def _observe_step(self, dt: float) -> None:
        self.last_step_s = dt
        self.step_s.append(dt)
        self.step_ewma_s = dt if self.step_ewma_s is None else \
            (1.0 - EWMA_ALPHA) * self.step_ewma_s + EWMA_ALPHA * dt

    def _observe_prefill(self, dt: float) -> None:
        self.last_prefill_s = dt
        self.prefill_ewma_s = dt if self.prefill_ewma_s is None else \
            (1.0 - EWMA_ALPHA) * self.prefill_ewma_s + EWMA_ALPHA * dt


def _engine_device(params, device) -> torch.device:
    """The engine's device (``cuda`` unless the caller asks for the CPU);
    raises when ``params`` live on another device."""
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params on {params['embed'].device}, engine on "
                         f"{dev}")
    return dev


class ServingEngine(_EngineBase):
    """Stacked-cache continuous batching: one in-place cache, one batched
    decode step for all slots, bucketed prefill where the model takes it.

    ``device`` defaults to ``cuda`` and raises when no card is present;
    pass ``device="cpu"`` to run the plain PyTorch path. ``params`` must
    already live on that device.
    """

    def __init__(self, model: Model, params, cfg: EngineConfig,
                 device=None):
        super().__init__(model, params, cfg)
        self.device = _engine_device(params, device)
        self._cache = model.init_cache(cfg.slots, cfg.max_seq, self.device)
        self._last = torch.zeros((cfg.slots,), dtype=torch.long,
                                 device=self.device)
        self._buckets = model.supports_padded_prefill

    def _admit(self) -> None:
        budget = int(self.cfg.chips * self.cfg.tokens_per_chip_step)
        for slot in range(self.cfg.slots):
            if slot in self.active or not self.queue:
                continue
            req = self.queue[0]
            prompt = self._truncate(req)
            n = len(prompt)
            if n > budget:
                continue                  # not enough budget this step
            self.queue.pop(0)
            budget -= n
            width = bucket_length(n, self.cfg.max_seq) if self._buckets \
                else n
            toks = np.zeros((1, width), np.int64)
            toks[0, :n] = prompt
            t0 = time.perf_counter()
            logits, one = self.model.prefill(
                self.params, {"tokens": torch.from_numpy(toks).to(self.device)},
                max_seq=self.cfg.max_seq,
                length=n if self._buckets else None)
            first = torch.argmax(logits[0])
            for key, big in self._cache.items():
                if key != "pos":
                    big[:, slot] = one[key][:, 0]
            self._cache["pos"][slot] = n
            self._last[slot] = first
            first = int(first)            # host sync: end of the admission
            self._observe_prefill(time.perf_counter() - t0)
            self.admissions += 1
            req.generated.append(first)
            self.active[slot] = req
            self.prompt_tokens_in += n

    def step(self) -> int:
        """One engine tick: admit, then ONE decode step for the whole slot
        pool. Returns tokens produced (for *active* slots — idle lanes
        free-run and their output is discarded)."""
        self._admit()
        t0 = time.perf_counter()
        logits, self._cache = self.model.decode(
            self.params, self._last[:, None], self._cache)
        self._last = torch.argmax(logits, dim=-1)
        toks = self._last.cpu().numpy()   # the step's one device->host sync
        self._observe_step(time.perf_counter() - t0)
        produced = 0
        finished = []
        for slot, req in list(self.active.items()):
            req.generated.append(int(toks[slot]))
            produced += 1
            if len(req.generated) >= req.max_new_tokens:
                req.done = True
                finished.append(slot)
                self.completed.append(req)
        for slot in finished:
            del self.active[slot]
        self.steps += 1
        self.tokens_out += produced
        return produced


class DictCacheEngine(_EngineBase):
    """Seed-era engine: per-slot cache dict, one batch-1 decode and one host
    sync per active slot, exact-length prefill. The e11 baseline and the
    seeded-parity oracle of ``ServingEngine``.

    ``device`` defaults to ``cuda`` and raises when no card is present;
    ``params`` must already live on that device.
    """

    def __init__(self, model: Model, params, cfg: EngineConfig,
                 device=None):
        super().__init__(model, params, cfg)
        self.device = _engine_device(params, device)
        self.caches: Dict[int, tuple] = {}        # slot -> (cache, last token)

    def _admit(self) -> None:
        budget = int(self.cfg.chips * self.cfg.tokens_per_chip_step)
        for slot in range(self.cfg.slots):
            if slot in self.active or not self.queue:
                continue
            req = self.queue[0]
            prompt = self._truncate(req)
            if len(prompt) > budget:
                continue                  # not enough budget this step
            self.queue.pop(0)
            budget -= len(prompt)
            toks = torch.from_numpy(prompt.astype(np.int64))[None, :]
            t0 = time.perf_counter()
            logits, cache = self.model.prefill(
                self.params, {"tokens": toks.to(self.device)},
                max_seq=self.cfg.max_seq)
            first = int(torch.argmax(logits[0]))      # host sync
            self._observe_prefill(time.perf_counter() - t0)
            self.admissions += 1
            req.generated.append(first)
            self.active[slot] = req
            self.caches[slot] = (cache, first)
            self.prompt_tokens_in += len(prompt)

    def step(self) -> int:
        """One engine tick: admit + one decode per active slot."""
        self._admit()
        produced = 0
        finished = []
        t0 = time.perf_counter()
        for slot, req in list(self.active.items()):
            cache, last = self.caches[slot]
            tok = torch.full((1, 1), last, dtype=torch.long,
                             device=self.device)
            logits, cache = self.model.decode(self.params, tok, cache)
            nxt = int(torch.argmax(logits[0]))        # host sync per slot
            req.generated.append(nxt)
            produced += 1
            if len(req.generated) >= req.max_new_tokens:
                req.done = True
                finished.append(slot)
                self.completed.append(req)
            else:
                self.caches[slot] = (cache, nxt)
        self._observe_step(time.perf_counter() - t0)
        for slot in finished:
            del self.active[slot], self.caches[slot]
        self.steps += 1
        self.tokens_out += produced
        return produced
