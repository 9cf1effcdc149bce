"""``ServedLMService`` — a *real* LM service under MUDAP's control (the
port's copy of ``repro/serve/service.py``).

The backend registered with the platform wraps an actual ``ServingEngine``
(stacked-cache continuous batching over a real PyTorch model, on the card
unless the caller asks for the CPU), and every telemetry row the
autoscaler sees is **measured** — wall-clock decode-step latency, live
queue depth, tokens/s — never an ``env/profiles.py`` response surface.
``served_lm_profile`` makes that contract explicit: its ``tp_max`` raises
if anything evaluates it.

Elasticity mapping (paper Table I, instantiated on serving):

  param    | strategy  | effect in the engine
  ---------+-----------+---------------------------------------------------
  chips    | resources | admission token budget AND the per-tick compute
           |           | budget (`steps_per_chip_s * chips` decode steps)
  context  | quality   | prompt truncation bound (data-quality dimension)
  rung     | quality   | model-variant switch on a ladder of down-sized
           |           | configs (model-size dimension); switching requeues
           |           | in-flight requests — an honest switch cost

The RASK agent fits its throughput regression on these measured rows, so
the loop ``serve/loop.py::run_serving_loop`` closes is: real decode steps
-> measured latency/throughput -> TimeSeriesDB -> RASK fit+solve ->
ScalingPlan -> engine admission/truncation/rung — the full Fig. 2 cycle on
the card's numbers.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.elasticity import ServiceId
from ..core.slo import SLO
from ..device import resolve_device
from ..env.profiles import ServiceProfile, _api
from .engine import EngineConfig, Request, ServingEngine

RUNG_FRACTION = {1: 0.25, 2: 0.5, 3: 0.75, 4: 1.0}   # rung -> d_model fraction


def _forbidden_tp_max(p) -> float:
    raise RuntimeError(
        "served_lm_profile.tp_max must never be called — the served LM "
        "service reports *measured* throughput; there is no analytic curve "
        "on its hot path")


def served_lm_profile(name: str = "lm-real", *, max_chips: float = 8.0,
                      context_max: float = 64.0, rung_slo: float = 3.0,
                      default_rps: float = 4.0) -> ServiceProfile:
    """Profile for a really-served LM: same ApiDescription shape as
    ``lm_profile`` (chips/context/rung) but with smoke-scale context bounds
    and a booby-trapped ``tp_max`` — telemetry comes from the engine."""
    return ServiceProfile(
        type=name,
        api=_api(name, [
            ("chips", "resources", "/resources", 0.25, max_chips, None, True),
            ("context", "quality", "/quality", 8.0, context_max, 4.0, False),
            ("rung", "quality", "/model", 1.0, 4.0, 1.0, False),
        ]),
        slos=(SLO("context", context_max / 2.0, 0.5),
              SLO("rung", rung_slo, 0.2),
              SLO("completion", 1.0, 1.0)),
        defaults={"chips": max_chips / 3.0, "context": context_max / 2.0,
                  "rung": 3.0},
        default_rps=default_rps,
        tp_max=_forbidden_tp_max,
        knowledge={"tp_max": ("chips", "context", "rung")},
        parallel_eff=0.85,
    )


def rung_config(base, rung: int):
    """Model variant for a rung: scale width by RUNG_FRACTION (floored to a
    multiple of 4 heads-worth, min 16) with d_ff = 2*d_model. Rung 4 is the
    base config itself, so the top rung costs nothing extra to build."""
    if rung == 4:
        return base
    fr = RUNG_FRACTION[int(rung)]
    d = max(16, int(base.d_model * fr) // 4 * 4)
    return dataclasses.replace(base, d_model=d, d_ff=2 * d)


class ServedLMService:
    """ServiceBackend over a ladder of ``ServingEngine``s (one per rung).

    ``advance(t, dt)`` is the real-work hook ``MUDAP.pump`` drives: it
    generates arrivals for the tick, then runs the chip-scaled number of
    engine decode steps (a deterministic budget, so seeded trajectories
    reproduce). ``metrics()`` reports only measured/config values.

    ``device`` defaults to ``cuda`` and raises when no card is present.
    Rung ``r``'s weights are drawn at its first use from a generator on
    the device seeded with ``17 + r``, unless ``_params_by_rung`` already
    holds them.
    """

    def __init__(self, model_builder, base_cfg, *, sid: Optional[ServiceId]
                 = None, profile: Optional[ServiceProfile] = None,
                 slots: int = 4, max_seq: int = 64, seed: int = 0,
                 prompt_len: float = 16.0, prompt_jitter: float = 4.0,
                 max_new_tokens: int = 8, steps_per_chip_s: float = 25.0,
                 buffer_s: float = 4.0, rps: float = 4.0, device=None):
        self.profile = profile or served_lm_profile()
        self.sid = sid or ServiceId("edge-0", self.profile.type, "c0")
        self.device = resolve_device(device)
        self._builder = model_builder
        self._base_cfg = base_cfg
        self._slots = slots
        self._max_seq = max_seq
        self._rng = np.random.default_rng(seed)
        self.prompt_len = prompt_len
        self.prompt_jitter = prompt_jitter
        self.max_new_tokens = max_new_tokens
        # the chip grant buys decode steps per second (an accelerator's step
        # rate is fixed; the share of it is what scales) — a DETERMINISTIC
        # compute budget, so seeded loop trajectories reproduce exactly
        # while the latency TELEMETRY stays measured wall-clock
        self.steps_per_chip_s = steps_per_chip_s
        self.buffer_s = buffer_s               # queue bound, seconds of load
        self.rps = rps
        d = self.profile.defaults
        self.chips = float(d["chips"])
        self.context = int(d["context"])
        self.rung = int(d["rung"])
        self._engines: Dict[int, ServingEngine] = {}
        self._params_by_rung: Dict[int, object] = {}
        self._next_rid = 0
        self._arrears = 0.0                    # fractional arrivals carry
        self.dropped = 0
        self.ledger: List[Request] = []        # all completed requests
        self._tick_completed = 0
        self._tick_steps = 0
        self._tick_wall = 0.0
        self._tick_tokens = 0
        self._pbar: Optional[float] = None     # EWMA admitted prompt length
        self._last_thr = 0.0
        self._last_tp_max = 0.0

    # -- engine ladder -------------------------------------------------------
    def _engine(self) -> ServingEngine:
        r = self.rung
        if r not in self._engines:
            cfg = rung_config(self._base_cfg, r)
            model = self._builder(cfg)
            if r not in self._params_by_rung:
                gen = torch.Generator(self.device).manual_seed(17 + r)
                self._params_by_rung[r] = model.init(gen)
            self._engines[r] = ServingEngine(
                model, self._params_by_rung[r],
                EngineConfig(slots=self._slots, max_seq=self._max_seq,
                             chips=self.chips, context=self.context,
                             rung=r), device=self.device)
        return self._engines[r]

    # -- ServiceBackend ------------------------------------------------------
    def apply(self, param: str, value: float) -> None:
        if param == "chips":
            self.chips = float(value)
        elif param == "context":
            self.context = int(value)
        elif param == "rung":
            new = int(round(value))
            if new != self.rung and self.rung in self._engines:
                # honest switch cost: in-flight work restarts on the new rung
                old = self._engines[self.rung]
                requeue = list(old.active.values()) + old.queue
                old.active.clear()
                old.queue.clear()
                self.rung = new
                eng = self._engine()
                for req in requeue:
                    req.generated = []
                    eng.queue.append(req)
            else:
                self.rung = new
        else:
            raise KeyError(param)
        for eng in self._engines.values():
            eng.apply("chips", self.chips)
            eng.apply("context", self.context)

    def metrics(self) -> Dict[str, float]:
        eng = self._engine()
        return {
            # measured service metrics
            "rps": float(self.rps),
            "throughput": self._last_thr,
            "tp_max": self._last_tp_max,
            "completion": min(self._last_thr / max(self.rps, 1e-9), 1.0),
            "queue": float(len(eng.queue)),
            "active": float(len(eng.active)),
            "step_latency_ms": 1e3 * (eng.step_ewma_s or eng.last_step_s),
            "tokens_per_s": (self._tick_tokens / self._tick_wall
                             if self._tick_wall > 0 else 0.0),
            "dropped": float(self.dropped),
            # applied elasticity parameters (SLO evaluation reads these)
            "chips": float(self.chips),
            "context": float(self.context),
            "rung": float(self.rung),
        }

    # -- real work ----------------------------------------------------------
    def advance(self, t: float, dt: float = 1.0) -> None:
        eng = self._engine()
        # arrivals: fractional-rate accumulator, bounded queue
        self._arrears += self.rps * dt
        n_new = int(self._arrears)
        self._arrears -= n_new
        cap = int(max(self.rps, 1.0) * self.buffer_s)
        for _ in range(n_new):
            if len(eng.queue) >= cap:
                self.dropped += 1
                continue
            plen = int(np.clip(self._rng.normal(self.prompt_len,
                                                self.prompt_jitter),
                               4, self._max_seq))
            prompt = self._rng.integers(
                0, eng.model.cfg.vocab, plen).astype(np.int32)
            eng.submit(Request(self._next_rid, prompt,
                               max_new_tokens=self.max_new_tokens))
            self._next_rid += 1
        # compute: the chip share buys a deterministic number of decode
        # steps this tick (always >= 1 probe step so latency stays
        # observable); each step's wall-clock is measured for telemetry
        budget = max(1, int(round(self.steps_per_chip_s * self.chips * dt)))
        spent = 0.0
        steps = 0
        tokens = 0
        done_before = len(eng.completed)
        while steps < budget:
            if not eng.active and not eng.queue:
                break
            t0 = time.perf_counter()
            tokens += eng.step()
            spent += time.perf_counter() - t0
            steps += 1
        completed = len(eng.completed) - done_before
        self.ledger.extend(eng.completed[done_before:])
        del eng.completed[done_before:]
        self._tick_completed = completed
        self._tick_steps = steps
        self._tick_wall = spent
        self._tick_tokens = tokens
        # capacity estimate from the applied parameters and request shape:
        # step rate granted by the chips times the concurrency the admission
        # budget sustains, over the tokens a request needs
        if steps:
            for req in self.ledger[-completed:] if completed else []:
                n = min(len(req.prompt), self.context, self._max_seq)
                self._pbar = n if self._pbar is None else \
                    0.75 * self._pbar + 0.25 * n
            pbar = self._pbar or self.prompt_len
            steps_cap = self.steps_per_chip_s * self.chips   # steps per s
            budget_tokens = self.chips * eng.cfg.tokens_per_chip_step
            conc = min(float(self._slots), budget_tokens / max(pbar, 1.0))
            self._last_tp_max = steps_cap * conc / max(
                self.max_new_tokens - 1.0, 1.0)
        self._last_thr = completed / dt
