"""Serving driver: a model behind the continuous-batching engine, fed
seeded synthetic requests (the counterpart of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --full          # card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu    # plain
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --engine dict
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-1.5-large-398b --device cpu

Without ``--full`` the registry config is cut to its ``.smoke()`` size in
float32, as in the JAX driver; ``--full`` runs it as registered (gemma3-1b:
26 layers, d_model 1152, vocab 262144, bf16; mamba2-370m: 48 layers,
d_model 1024, vocab 50280, bf16; qwen2-moe-a2.7b: 24 layers, d_model 2048,
60 experts top-4 and 4 shared, vocab 151936, bf16, 28.6 GB of weights).
The MoE model's prompts are padded to buckets, as the dense decoder's
are; a prompt is routed in groups of 512 tokens, so a padded width above
512 must be a multiple of 512 (a power-of-two bucket is, one clamped to
an odd ``max_seq`` may not be). Weights are random, drawn
from a seeded ``torch.Generator`` on the device. The device defaults to
``cuda``, and a missing card is an error. ``--engine dict`` selects the
seed-era per-slot-cache baseline (one batch-1 decode per active slot); the
default stacked engine decodes every slot in one batched step.

jamba-1.5-large-398b (hybrid) serves its smoke cut (8 layers: one period,
4 experts) with exact-length prompts; at full depth its 398 B parameters
fit no single card (``chip_smoke.py`` serves a one-period, 8-expert cut
at full width). whisper-large-v3 raises a ``ValueError``: the engine
prefills token prompts and takes no audio frames.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get
from ..device import resolve_device
from ..kernels import _build
from ..models import build
from ..serve.engine import (DictCacheEngine, EngineConfig, Request,
                            ServingEngine)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--engine", choices=("stacked", "dict"),
                    default="stacked")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="run the registered config, not its .smoke() cut")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get(args.arch)
    if not args.full:
        cfg = dataclasses.replace(cfg.smoke(), dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator(device).manual_seed(args.seed))
    max_seq = args.prompt_len + args.max_new + 8
    cls = ServingEngine if args.engine == "stacked" else DictCacheEngine
    engine = cls(model, params, EngineConfig(
        slots=args.slots, max_seq=max_seq, context=args.prompt_len,
        chips=max(4.0, args.prompt_len / 16)), device=device)

    if device.type == "cuda":
        _build.build_all()       # compile the kernels before the clock starts
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        engine.submit(Request(
            rid, rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new))

    t0 = time.perf_counter()
    ticks = 0
    while len(engine.completed) < args.requests and ticks < 10_000:
        engine.step()
        ticks += 1
    dt = time.perf_counter() - t0
    print(f"[{cfg.name} {args.engine} on {device}] completed "
          f"{len(engine.completed)}/{args.requests} requests in {ticks} engine steps, {dt:.1f}s; "
          f"tokens_out={engine.tokens_out} "
          f"({engine.tokens_out / max(dt, 1e-9):.1f} tok/s, "
          f"step={1e3 * (engine.step_ewma_s or 0.0):.2f}ms)")
    return engine


if __name__ == "__main__":
    main()
