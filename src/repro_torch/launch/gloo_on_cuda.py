"""Whether ``gloo`` carries the dense decoder's steps on CUDA tensors: two
``gloo`` ranks on one card (NCCL refuses two ranks on one GPU).

    PYTHONPATH=src python -m repro_torch.launch.gloo_on_cuda

A probe run by hand, not a check: each rank first calls the collectives
that DTensor's redistributions use (``broadcast``, ``all_reduce``,
``all_gather``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``)
directly on CUDA tensors, then runs the prefill, decode and train steps of
gemma3-1b at full width cut to 2 layers (vocab 4,096, float32) on a (1, 2)
and a (2, 1) mesh. Each step's outcome, or its error, is written as it
ends, and a crash's Python stack is kept (``faulthandler``), so the output
names the first step that fails. The ranks rendezvous through a
``FileStore`` in a temporary directory and are killed after ``--timeout``
seconds. It prints one JSON object and exits 0 whatever the ranks did.
"""
from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import json
import os
import tempfile
import time
from pathlib import Path

import torch

COLLECTIVES = ("broadcast", "all_reduce", "all_gather",
               "all_gather_into_tensor", "reduce_scatter_tensor")


def _rank(rank, store, out_dir, device):
    """One of the two ranks, both on card 0."""
    import torch.distributed as dist

    from ..configs import get
    from ..models import build
    from ..train.optimizer import AdamWConfig, adamw
    from . import sharding as SH
    from .mesh import make_debug_mesh
    from .steps import make_decode_step, make_prefill_step, make_train_step
    os.environ["LOCAL_RANK"] = "0"
    crash = open(Path(out_dir, f"rank{rank}.fault"), "w")
    faulthandler.enable(file=crash)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    out = {}

    def note(key, row, step, result="ok"):
        row[step] = result
        out[key] = row
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    try:
        dev = torch.device(device, 0) if device == "cuda" else \
            torch.device(device)
        sync = torch.cuda.synchronize if dev.type == "cuda" else \
            (lambda: None)
        x = torch.full((4, 8), float(rank + 1), device=dev)
        ops = {
            "broadcast": lambda: dist.broadcast(x.clone(), 0),
            "all_reduce": lambda: dist.all_reduce(x.clone()),
            "all_gather": lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(2)], x),
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                x.new_empty((8, 8)), x),
            "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                x.new_empty((2, 8)), x)}
        probes = {}
        for name in COLLECTIVES:
            try:
                ops[name]()
                sync()
                note("collectives", probes, name)
            except Exception as e:
                note("collectives", probes, name,
                     f"{type(e).__name__}: {str(e)[:300]}")
        for shape in ((1, 2), (2, 1)):
            key, row = f"{shape[0]}x{shape[1]}", {}
            mesh = make_debug_mesh(*shape, device=device)
            cfg = dataclasses.replace(get("gemma3-1b"), n_layers=2,
                                      vocab=4096, dtype="float32")
            gen = torch.Generator(mesh.device).manual_seed(0)
            params = build(cfg).init(gen)
            toks = torch.randint(0, cfg.vocab, (2, 128), generator=gen,
                                 device=mesh.device, dtype=torch.int32)
            try:
                pre = make_prefill_step(cfg, mesh, 2, 256)
                placed = SH.place(params, pre.in_shardings[0])
                note(key, row, "placed")
                tok, cache = pre.fn(placed, {"tokens": toks})
                sync()
                note(key, row, "prefill")
                dec = make_decode_step(cfg, mesh, 2, 256)
                dec.fn(placed, tok.full_tensor()[:, None], cache)
                sync()
                note(key, row, "decode")
                tr = make_train_step(cfg, mesh, 2, 128)
                p = SH.place(params, tr.in_shardings[0])
                o = SH.place(adamw(AdamWConfig())[0](p),
                             tr.in_shardings[1])
                tr.fn(p, o, {"tokens": toks, "labels": toks})
                sync()
                note(key, row, "train")
            except Exception as e:
                note(key, row, "error",
                     f"{type(e).__name__}: {str(e)[:400]}")
    finally:
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
        dist.destroy_process_group()


def probe(device: str = "cuda", timeout_s: float = 150.0) -> dict:
    """Spawn the two ranks, wait at most ``timeout_s``, kill what is left,
    and report each rank's steps and any crash's stack."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank, args=(f"{tmp}/store", tmp, device),
                                 nprocs=2, join=False, start_method="spawn")
        status = "ok"
        try:
            while not ctx.join(timeout=1.0):
                if time.perf_counter() - t0 > timeout_s:
                    status = f"timeout after {timeout_s} s"
                    break
        except Exception as e:
            status = f"{type(e).__name__}: {str(e)[:400]}"
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
        ranks = {}
        for r in range(2):
            f, fault = Path(tmp, f"rank{r}.json"), Path(tmp, f"rank{r}.fault")
            ranks[r] = {"steps": json.loads(f.read_text()) if f.exists()
                        else None,
                        "fault": fault.read_text()[:1500]
                        if fault.exists() else ""}
    return {"status": status, "ranks": ranks, "torch": torch.__version__,
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=150.0)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    print(json.dumps(probe(args.device, args.timeout)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
