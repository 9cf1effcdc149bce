"""End-to-end training entry point (the counterpart of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --steps 50 --batch 8 --seq 128          # on the card

As in ``repro``, ``--smoke`` is on (the registry config's ``.smoke()``
cut), and training runs in float32 with the synthetic ``TokenPipeline``,
AdamW (warmup 10, cosine over ``--steps``), checkpoint/restart and
straggler monitoring through the ``Trainer``. Weights are random, from a
seeded ``torch.Generator`` on the device. The step is the ``StepBundle``
of ``launch/steps.py`` built on ``make_debug_mesh()`` over the card
(``--device cpu``: the CPU's mesh); a missing card is an error. On the
card the gradients of attention and of the SSD scan are their backward
kernels, so mamba2 and jamba train there as the decoders do (``--arch
mamba2-370m``); whisper raises everywhere (the pipeline makes tokens, not
audio frames).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from ..configs import get
from ..data import TokenPipeline
from ..device import upload
from ..kernels import _build
from ..models import build
from ..train.optimizer import AdamWConfig, adamw, compressed_adamw
from ..train.trainer import Trainer, TrainerConfig
from .mesh import make_debug_mesh
from .steps import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--compressed-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_train_ckpt in the temp dir")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mesh = make_debug_mesh(device=args.device)
    device = mesh.device
    cfg = get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    cfg = dataclasses.replace(cfg, dtype="float32", remat="none")
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.name}: the token pipeline makes no audio "
                         "frames for an encoder-decoder")
    model = build(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10,
                          total_steps=args.steps)
    opt_init, _ = (compressed_adamw if args.compressed_grads
                   else adamw)(opt_cfg)
    params = model.init(torch.Generator(device).manual_seed(0))
    opt_state = opt_init(params)
    step_fn = make_train_step(cfg, mesh, args.batch, args.seq,
                              compressed_grads=args.compressed_grads,
                              opt_cfg=opt_cfg).fn
    if device.type == "cuda":
        _build.build_all()       # compile the kernels before the clock starts
    pipeline = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_train_ckpt")
    trainer = Trainer(step_fn, params, opt_state, pipeline,
                      TrainerConfig(total_steps=args.steps,
                                    ckpt_every=max(args.steps // 2, 10),
                                    ckpt_dir=ckpt_dir),
                      to_device=lambda b: {k: upload(v, device)
                                           for k, v in b.items()})
    if args.resume:
        print(f"resumed at step {trainer.maybe_restore()}")
    history = trainer.run()
    first = history[0]["loss"] if history else float("nan")
    last = history[-1]["loss"] if history else float("nan")
    print(f"loss {first:.4f} -> {last:.4f} over {len(history)} steps; "
          f"stragglers={len(trainer.monitor.stragglers)}")
    return history


if __name__ == "__main__":
    main()
