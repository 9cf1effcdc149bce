"""Training loop with the fault-tolerance substrate wired in (the
counterpart of ``repro/train/trainer.py``).

* checkpoint/restart: ``maybe_restore`` restores the latest checkpoint,
  ``run`` saves every ``ckpt_every`` steps (async), and on SIGTERM/SIGINT
  or completion makes a final blocking save (preemption handling);
* straggler mitigation: per-step wall times feed a ``StragglerMonitor``
  (running median); steps slower than ``threshold x`` the median are
  counted and surfaced through its callback.

Each step reads the loss to the host, which waits for the step's work on
the card: one sync a step, where ``repro`` blocks on the loss.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from .checkpoint import CheckpointManager


class StragglerMonitor:
    """Flags steps slower than ``threshold x`` the running median."""

    def __init__(self, threshold: float = 2.0, window: int = 50,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.threshold = threshold
        self.window = window
        self.times: List[float] = []
        self.stragglers: List[int] = []
        self.on_straggler = on_straggler

    def record(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = float(np.median(self.times))
        slow = len(self.times) >= 5 and dt > self.threshold * med
        if slow:
            self.stragglers.append(step)
            if self.on_straggler:
                self.on_straggler(step, dt / med)
        return slow


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_keep: int = 3
    log_every: int = 10


class Trainer:
    def __init__(self, step_fn, params, opt_state, pipeline,
                 cfg: Optional[TrainerConfig] = None,
                 to_device: Optional[Callable] = None):
        """step_fn(params, opt_state, batch) -> (params, opt_state, metrics)
        with tensor (or number) metrics including ``"loss"``;
        pipeline.batch_at(step) -> host batch dict."""
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.pipeline = pipeline
        self.cfg = cfg = cfg or TrainerConfig()
        self.to_device = to_device or (lambda b: b)
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep)
        self.monitor = StragglerMonitor()
        self.history: List[Dict[str, float]] = []
        self._stop = False
        self.start_step = 0

    # -- fault tolerance -----------------------------------------------------
    def maybe_restore(self, shardings=None) -> int:
        """Restore the latest checkpoint, if any, onto the devices of the
        state's leaves, or of ``shardings`` (``CheckpointManager.restore``);
        returns the step to start from."""
        latest = self.ckpt.latest_step()
        if latest is not None:
            self.params, self.opt_state = self.ckpt.restore(
                (self.params, self.opt_state), step=latest,
                shardings=shardings)
            self.start_step = latest
        return self.start_step

    def _install_signals(self):
        def handler(signum, frame):
            self._stop = True
        try:
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGINT, handler)
        except ValueError:
            pass   # not on main thread (tests)

    # -- loop -----------------------------------------------------------------
    def run(self) -> List[Dict[str, float]]:
        self._install_signals()
        step = self.start_step
        while step < self.cfg.total_steps and not self._stop:
            batch = self.to_device(self.pipeline.batch_at(step))
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            float(metrics["loss"])           # waits for the step's work
            dt = time.perf_counter() - t0
            step += 1
            slow = self.monitor.record(step, dt)
            rec = {"step": step, "time_s": dt, "straggler": float(slow),
                   **{k: float(v) for k, v in metrics.items()}}
            self.history.append(rec)
            if step % self.cfg.ckpt_every == 0:
                self.ckpt.save(step, (self.params, self.opt_state))
            if step % self.cfg.log_every == 0:
                print(f"step {step}: loss={rec['loss']:.4f} "
                      f"{dt*1e3:.0f}ms" + (" STRAGGLER" if slow else ""))
        # preemption or completion: final blocking save
        self.ckpt.save(step, (self.params, self.opt_state), blocking=True)
        return self.history
