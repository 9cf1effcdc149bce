"""Dry run: price every (arch x shape x mesh) cell on the meta device (the
counterpart of ``repro/launch/dryrun.py``).

Per cell the dry run:
  1. builds the production mesh (16x16 single-pod / 2x16x16 multi-pod),
  2. builds the step (train_step / prefill / serve_step) with the sharding
     rules of ``launch/sharding.py``, on meta tensors,
  3. runs the step once on meta under ``launch/op_cost.py``: the counts
     are global (one program, not SPMD-partitioned),
  4. records the counted flops and bytes, the exact per-device bytes of
     the arguments under the rules, and the roofline terms against one
     H100's peaks.

``repro`` lowers and compiles each cell for 512 placeholder TPU devices
and reads XLA's HLO; the port needs no device and no compiler. Attention
and the SSD scan are counted by their kernels' own work (``op_cost``'s
kernel rows), the other ops as eager PyTorch runs them, one by one; the
plain versions' counts are kept beside (``memory["flops_plain_global"]``,
``["bytes_plain_global"]``). A failing cell is a bug in the framework and
fails the run.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        --out /tmp/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

from ..configs import SHAPES, cells, config_for_shape, get
from ..models.config import ModelConfig
from . import op_cost
from . import sharding as SH
from .mesh import make_production_mesh
from .steps import make_decode_step, make_prefill_step, make_train_step

# One NVIDIA H100 SXM, the data sheet's dense peaks at its 700 W limit:
# 989 TFLOP/s in bf16 (and fp16) on the tensor cores, 67 TFLOP/s in float32
# outside them (the port's float32 matmuls are cuBLAS SGEMM), 3.35 TB/s of
# HBM3. A card set below 700 W runs slower than these.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
# The port's hand-written kernels run a float32 product as three TF32
# products on the tensor cores (494.7 TFLOP/s dense TF32, the same sheet).
KERNEL_PEAK_FLOPS = {**PEAK_FLOPS, "float32": 494.7e12 / 3}
HBM_BW = 3.35e12             # bytes/s


def model_flops(cfg: ModelConfig, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (prefill) / 2*N per token (decode),
    with N = active params."""
    n = cfg.n_params_active()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    # decode: one token per sequence + attention reads (not in 2N heuristic)
    return 2.0 * n * shape.global_batch


@dataclasses.dataclass
class CellResult:
    """``repro``'s fields. ``compile_s`` is the host seconds of building the
    step and running it on meta; ``memory`` holds the port's global
    counts, the plain versions' beside them, and the knobs
    (``remat_applied``: the port has no remat);
    ``collective_*`` are empty and 0 (one program on one device)."""
    arch: str
    shape: str
    mesh: str
    compile_s: float
    per_device_flops: float
    per_device_bytes: float
    collective_bytes_per_device: float
    collectives: dict
    collective_counts: dict
    memory: dict
    arg_bytes_per_device: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_flops_frac: float
    skip: str = ""


def default_knobs(cfg: ModelConfig) -> dict:
    """Baseline remat/microbatch settings by model size (overridable)."""
    n = cfg.n_params()
    if n >= 60e9:
        return {"remat": "full", "microbatches": 16}
    if n >= 10e9:
        return {"remat": "full", "microbatches": 8}
    return {"remat": "dots", "microbatches": 1}


def run_cell(cfg: ModelConfig, shape, mesh, mesh_name: str, *,
             fsdp: bool = True, microbatches: int = None) -> CellResult:
    """Build the cell's ``StepBundle`` on ``mesh``'s shape with meta
    arguments, run ``bundle.fn`` once on meta under ``op_cost``, and
    price it.

    The counts are global. ``per_device_flops`` and ``per_device_bytes``
    are the counts over the mesh's size: the even split the rules aim at,
    not a partitioned program's own count. ``arg_bytes_per_device`` is
    exact (``sharding.sharded_size_bytes``). The roofline terms divide
    the per-device counts by one H100's peaks: the kernels' flops by
    ``KERNEL_PEAK_FLOPS``, the other ops' by ``PEAK_FLOPS`` (cuBLAS
    without TF32), both by the cell's dtype, the bytes by ``HBM_BW``. The
    bound, their max, is the least time the card could take for the step
    as the port runs it: the eager ops unfused, the kernels by their own
    work. It is not a share of what a fused step could reach, and the L2
    can serve an eager op some bytes that the op before it wrote.
    ``default_knobs``' remat is recorded as ``remat_asked`` and not
    applied: the port keeps every activation."""
    knobs = default_knobs(cfg)
    remat = knobs["remat"]
    if microbatches is None:
        # per-microbatch batch must divide the batch-shard product, else the
        # pod axis idles (repro's multi-pod scaling check)
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        shards = sizes.get("pod", 1) * sizes.get("data", 1)
        microbatches = min(knobs["microbatches"],
                           max(shape.global_batch // shards, 1))
    if shape.kind != "train":
        remat, microbatches = "none", 1
    on_meta = mesh.abstract()
    t0 = time.time()
    if shape.kind == "train":
        bundle = make_train_step(cfg, on_meta, shape.global_batch,
                                 shape.seq_len, fsdp=fsdp,
                                 microbatches=microbatches)
    elif shape.kind == "prefill":
        bundle = make_prefill_step(cfg, on_meta, shape.global_batch,
                                   shape.seq_len, fsdp=fsdp)
    else:
        bundle = make_decode_step(cfg, on_meta, shape.global_batch,
                                  shape.seq_len, fsdp=fsdp)
    _, cost = op_cost.count(bundle.fn, *bundle.args)
    compile_s = time.time() - t0

    n_dev = mesh.size
    totals, plain = cost.totals(), cost.totals(plain=True)
    flops = totals["flops"] / n_dev
    bytes_accessed = totals["bytes"] / n_dev
    kernel_flops = sum(r.flops for r in cost.rows.values() if r.kernel)
    compute_s = ((totals["flops"] - kernel_flops) / PEAK_FLOPS[cfg.dtype]
                 + kernel_flops / KERNEL_PEAK_FLOPS[cfg.dtype]) / n_dev
    memory_s = bytes_accessed / HBM_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": 0.0}
    bottleneck = max(terms, key=terms.get)

    mf = model_flops(cfg, shape)
    useful = mf / totals["flops"] if totals["flops"] else 0.0
    arg_bytes = SH.sharded_size_bytes(bundle.args, bundle.in_shardings)
    memory = {"flops_global": totals["flops"],
              "bytes_global": totals["bytes"],
              "transcendentals_global": totals["transcendentals"],
              "kernel_flops_global": kernel_flops,
              "flops_plain_global": plain["flops"],
              "bytes_plain_global": plain["bytes"],
              "microbatches": microbatches, "remat_asked": remat,
              "remat_applied": "none"}
    return CellResult(
        arch=cfg.name, shape=shape.name, mesh=mesh_name,
        compile_s=round(compile_s, 1),
        per_device_flops=flops, per_device_bytes=bytes_accessed,
        collective_bytes_per_device=0.0,
        collectives=totals["collectives"],
        collective_counts=totals["collective_counts"], memory=memory,
        arg_bytes_per_device=int(arg_bytes),
        compute_s=compute_s, memory_s=memory_s, collective_s=0.0,
        bottleneck=bottleneck, model_flops=mf,
        useful_flops_frac=round(useful, 4))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--out", default=None,
                    help="a directory for one JSON file a cell (default: "
                         "print only)")
    args = ap.parse_args(argv)

    meshes = []
    if args.both_meshes or not args.multi_pod:
        meshes.append(("pod16x16", make_production_mesh(multi_pod=False)))
    if args.both_meshes or args.multi_pod:
        meshes.append(("pods2x16x16", make_production_mesh(multi_pod=True)))

    if args.all:
        todo = [(c, s) for c, s, skip in cells() if skip is None]
    else:
        shape = SHAPES[args.shape]
        todo = [(config_for_shape(get(args.arch), shape), shape)]

    out = Path(args.out) if args.out else None
    if out:
        out.mkdir(parents=True, exist_ok=True)
    results = []
    t_all = time.time()
    for cfg, shape in todo:
        for mesh_name, mesh in meshes:
            tag = f"{cfg.name} x {shape.name} x {mesh_name}"
            try:
                r = run_cell(cfg, shape, mesh, mesh_name,
                             fsdp=bool(args.fsdp),
                             microbatches=args.microbatches)
            except Exception as e:  # a failing cell is a bug: surface it
                print(f"FAIL {tag}: {type(e).__name__}: {e}")
                raise
            results.append(dataclasses.asdict(r))
            print(f"OK {tag}: host={r.compile_s}s "
                  f"flops/dev={r.per_device_flops:.3e} "
                  f"bytes/dev={r.per_device_bytes:.3e} "
                  f"args/dev={r.arg_bytes_per_device:.3e} "
                  f"bottleneck={r.bottleneck} "
                  f"useful={r.useful_flops_frac}", flush=True)
            if out:
                (out / f"{cfg.name}_{shape.name}_{mesh_name}.json"
                 ).write_text(json.dumps(dataclasses.asdict(r), indent=1))
    print(f"{len(results)} cells in {time.time() - t_all:.1f} s of host "
          "time (meta device)")
    return results


if __name__ == "__main__":
    main()
