"""Deterministic synthetic token pipeline (sharded, restart-safe).

The port's own copy of ``repro/data/pipeline.py`` (numpy only; the port
imports nothing of the JAX package): ``batch_at(step)`` gives the same
bytes as ``repro``'s for the same arguments, so both packages train on one
stream.

Sequences are generated from a fixed random bigram chain plus noise — enough
structure that a ~100M model's loss visibly falls within a few hundred
steps, while staying fully procedural (no external data).

Sharding/restart contract (the part that matters at 1000 nodes):
  * every (host, step) pair maps to a unique deterministic seed, so
    restarting from a checkpoint at step K reproduces the exact stream by
    construction (no data-loader state to checkpoint);
  * hosts draw disjoint slices of the global batch: host h of H gets rows
    [h*B/H, (h+1)*B/H).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    batch: int                  # global batch (sequences)
    seq: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    noise: float = 0.1          # fraction of uniform-random tokens

    def __post_init__(self):
        assert self.batch % self.n_hosts == 0
        rng = np.random.default_rng(self.seed)
        # sparse bigram chain: each token has 4 plausible successors
        self._succ = rng.integers(0, self.vocab, size=(self.vocab, 4),
                                  dtype=np.int64)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The (host-local) batch for ``step`` — pure function of (seed, step,
        host). tokens/labels are the usual shifted pair."""
        local = self.batch // self.n_hosts
        rng = np.random.default_rng(
            (self.seed, step, self.host_id))
        toks = np.empty((local, self.seq + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, local)
        choices = rng.integers(0, 4, size=(local, self.seq))
        noise_mask = rng.random((local, self.seq)) < self.noise
        noise_toks = rng.integers(0, self.vocab, size=(local, self.seq))
        for t in range(self.seq):
            nxt = self._succ[toks[:, t], choices[:, t]]
            toks[:, t + 1] = np.where(noise_mask[:, t], noise_toks[:, t], nxt)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
