#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out report.json]

Phase 0 builds every CUDA kernel from src/repro_torch/kernels/csrc with nvcc
(sm_90a), one nvcc per source, all at once.

Phase 1 holds each kernel against its plain PyTorch version on the card, on
the shapes the serving path gives it, in float32 (tolerance 2e-5) and bf16
(5e-2), the tolerances of tests/test_kernels.py. It times the kernel, the
plain version and ``scaled_dot_product_attention`` (the library yardstick,
which the port never calls): device time (CUDA events around calls queued
behind a device spin, so the host does not pace them) and call time. It computes each kernel's bound: the larger of the bytes
it must move over 3.35 TB/s and its flops over the peak rate for its type
(989 TFLOP/s bf16, 67 TFLOP/s float32), from the H100 SXM data sheet.

Phase 2 cross-checks gemma3-1b at full width (d_model 1152, vocab 262144),
cut to 2 layers (one local, one global), in float32: a 300-token prefill
and 4 decode steps on the card against the same weights on the CPU.

Phase 3 is the slice: gemma3-1b at full width in bf16, random weights from
a seeded generator, behind the continuous-batching ServingEngine (4 slots,
max_seq 2048, context 1024), serving 8 requests of 100 to 1000 prompt
tokens and 16 new tokens each. Launch counters are zeroed just before and
read just after; every layer of every decode step and every prefill must
have gone through the kernels. A profiler window over a few decode steps
and one prefill then says where the time goes (after the counters are
read).

Prints the card's name and power limit, one JSON line per phase, a
``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0).
Without a card, or without the repository beside it, it exits 2 and prints
no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

SRC = Path(__file__).resolve().parent / "src"

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 2e-5, "bfloat16": 5e-2}  # tests/test_kernels.py::_tol


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _events_ms(fns, iters, spin_cycles=0):
    """CUDA-event ms per call over ``iters`` calls cycling through ``fns``,
    optionally behind a device spin of ``spin_cycles``; returns (ms, host
    seconds spent queueing the calls)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if spin_cycles:
        torch.cuda._sleep(spin_cycles)
    a.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fns[i % len(fns)]()
    queued = time.perf_counter() - t0
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters, queued


def time_ms(fns, iters):
    """(device ms, call ms) per call, cycling through ``fns`` (distinct
    input copies, so that data larger than L2 is read cold, as on the path).

    Call ms: CUDA events around the loop, which is what a caller waits,
    host overhead included when the host is the slower side. Device ms: the
    same loop queued behind a device spin that outlasts the host's queueing,
    so the calls run back to back and the events time the card alone."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    call, queued = _events_ms(fns, iters)
    per_ms, _ = _events_ms([lambda: torch.cuda._sleep(1 << 20)], 1)
    cycles_per_ms = (1 << 20) / per_ms
    for _ in range(3):
        spin_ms = 2e3 * queued + 1.0
        device, queued_now = _events_ms(fns, iters,
                                        int(spin_ms * cycles_per_ms))
        if 1e3 * queued_now < spin_ms:   # every call was queued in time
            return device, call
        queued = queued_now
    raise RuntimeError("the host could not queue the timed calls ahead of "
                       "the device")


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


# -- phase 1: kernels against their plain versions ------------------------------

def decode_cases(dev, dtype):
    """The decode kernel's inputs on the serving path: 4 slots, 4 query
    heads on 1 kv head, d_head 256, a 2048-slot cache, per-row lengths of
    the phase-3 prompts, global rows (start 0) and local rows (512 window),
    plus edge rows (length 1, a full cache, an idle lane past the cache)."""
    B, H, KH, D, S = 4, 4, 1, 256, 2048
    lengths = [108, 308, 708, 1008]
    cases = {
        "global": (lengths, [0] * 4),
        "local": (lengths, [max(0, n - 512) for n in lengths]),
        "edges": ([1, 2048, 2060, 513], [0, 1536, 1548, 1]),
    }
    g = torch.Generator(dev).manual_seed(11)
    out = []
    for name, (lens, starts) in cases.items():
        q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
        k = torch.randn((B, S, KH, D), generator=g, device=dev).to(dtype)
        v = torch.randn((B, S, KH, D), generator=g, device=dev).to(dtype)
        length = torch.tensor(lens, dtype=torch.int32, device=dev)
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        out.append((name, q, k, v, length, start))
    return out


def flash_cases(dev, dtype):
    """The flash kernel's inputs on the serving path: one prompt, 4 query
    heads on 1 kv head, d_head 256, at the 128/512/1024 buckets, local
    (window 512) and global (no window)."""
    g = torch.Generator(dev).manual_seed(12)
    out = []
    for S in (128, 512, 1024):
        for window in (512, 0):
            q = torch.randn((1, 4, S, 256), generator=g, device=dev).to(dtype)
            k = torch.randn((1, 1, S, 256), generator=g, device=dev).to(dtype)
            v = torch.randn((1, 1, S, 256), generator=g, device=dev).to(dtype)
            out.append((f"S{S}_w{window}", q, k, v, window))
    return out


def phase_kernels(dev):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for name, q, k, v, length, start in decode_cases(dev, dtype):
            got = decode_attention_cuda(q, k, v, length, start)
            want = ref.decode_attention_reference(q, k, v, length, start)
            torch.cuda.synchronize()
            # an idle lane's empty range: the kernel gives zeros, the plain
            # version a mean of V; nobody reads that lane, so compare the
            # rows whose range holds a slot
            live = (torch.minimum(length, torch.tensor(k.shape[1], device=dev))
                    > start)
            err = (got.float() - want.float())[live].abs().max().item()
            check(err <= TOL[dname], f"decode {name} {dname}: error {err}")
            B, H, D = q.shape
            S, KH = k.shape[1], k.shape[2]
            span = (torch.clamp(length, max=S) - start).clamp(min=0)
            slots = int(span.sum())
            es = q.element_size()
            nbytes = 2 * B * H * D * es + 2 * slots * KH * D * es + 8 * B
            flops = 4 * H * D * slots
            row = {"kernel": "decode_attention", "case": name,
                   "dtype": dname, "max_abs_err": err,
                   "bound": bound_ms(nbytes, flops, dname)}
            # timing: 8 input copies (8 x 8 MB in bf16) exceed the 50 MB L2,
            # as the decode step, which streams ~2 GB of weights between
            # two calls of one layer, finds the cache cold
            copies = [(q.clone(), k.clone(), v.clone()) for _ in range(8)]
            pos = torch.arange(S, device=dev)[None, :]
            mask = ((pos < length[:, None]) & (pos >= start[:, None])
                    )[:, None, None, :]
            row["ms"], row["call_ms"] = time_ms([
                (lambda c=c: decode_attention_cuda(c[0], c[1], c[2], length,
                                                   start)) for c in copies],
                50)
            row["plain_ms"], row["plain_call_ms"] = time_ms([
                (lambda c=c: ref.decode_attention_reference(
                    c[0], c[1], c[2], length, start)) for c in copies], 20)

            def sdpa(c):
                kk = c[1].transpose(1, 2).expand(B, H, S, D)
                vv = c[2].transpose(1, 2).expand(B, H, S, D)
                return F.scaled_dot_product_attention(
                    c[0][:, :, None], kk, vv, attn_mask=mask)[:, :, 0]
            lib = sdpa(copies[0])
            torch.cuda.synchronize()
            row["library_err"] = (lib.float() - want.float())[live].abs() \
                .max().item()
            row["library_ms"], row["library_call_ms"] = time_ms(
                [(lambda c=c: sdpa(c)) for c in copies], 20)
            rows.append(row)
            log(f"decode {name} {dname}: {row}")

        for name, q, k, v, window in flash_cases(dev, dtype):
            got = flash_attention_cuda(q, k, v, causal=True, window=window)
            want = ref.flash_attention_reference(q, k, v, causal=True,
                                                 window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(err <= TOL[dname], f"flash {name} {dname}: error {err}")
            B, H, S, D = q.shape
            T = k.shape[2]
            qpos = torch.arange(S, device=dev)[:, None] + (T - S)
            kpos = torch.arange(T, device=dev)[None, :]
            open_ = qpos >= kpos
            if window:
                open_ &= qpos - kpos < window
            pairs = int(open_.sum())
            es = q.element_size()
            nbytes = (2 * q.numel() + 2 * k.numel()) * es
            flops = 4 * B * H * D * pairs
            row = {"kernel": "flash_attention", "case": name, "dtype": dname,
                   "max_abs_err": err, "bound": bound_ms(nbytes, flops, dname)}
            row["ms"], row["call_ms"] = time_ms([
                lambda: flash_attention_cuda(q, k, v, causal=True,
                                             window=window)], 20)
            row["plain_ms"], row["plain_call_ms"] = time_ms([
                lambda: ref.flash_attention_reference(
                    q, k, v, causal=True, window=window)], 10)
            kk, vv = k.expand(B, H, T, D), v.expand(B, H, T, D)
            if window:
                def sdpa():
                    return F.scaled_dot_product_attention(q, kk, vv,
                                                          attn_mask=open_)
            else:
                def sdpa():
                    return F.scaled_dot_product_attention(q, kk, vv,
                                                          is_causal=True)
            lib = sdpa()
            torch.cuda.synchronize()
            row["library_err"] = (lib.float() - want.float()).abs().max() \
                .item()
            row["library_ms"], row["library_call_ms"] = time_ms([sdpa], 20)
            rows.append(row)
            log(f"flash {name} {dname}: {row}")
    return rows


# -- phase 2: full-width cross-check against the CPU -------------------------------

def phase_crosscheck(dev):
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.models import build

    # 1e-3: the same float32 arithmetic on the card (no TF32) and the CPU
    # differs only in summation order, ~1e-6 relative per matmul; logits
    # are O(1) after 2 layers, so 1e-3 is loose enough for any order and
    # tight enough to catch a wrong mask, window, position or cache write
    tol = 1e-3
    cfg = dataclasses.replace(get("gemma3-1b"), n_layers=2,
                              local_global_period=2, dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator(dev).manual_seed(1))
    cpu_params = {
        "embed": params["embed"].cpu(),
        "final_norm": {"scale": params["final_norm"]["scale"].cpu()},
        "layers": [_to_cpu(lp) for lp in params["layers"]]}
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (1, 300))
    gl, gc = model.prefill(params, {"tokens": torch.from_numpy(toks).to(dev)},
                           max_seq=512)
    cl, cc = model.prefill(cpu_params, {"tokens": torch.from_numpy(toks)},
                           max_seq=512)
    errs = [(gl.cpu() - cl).abs().max().item()]
    same = [int(gl.argmax()) == int(cl.argmax())]
    for _ in range(4):
        nxt = cl.argmax(-1)[:, None]
        gl, gc = model.decode(params, nxt.to(dev), gc)
        cl, cc = model.decode(cpu_params, nxt, cc)
        errs.append((gl.cpu() - cl).abs().max().item())
        same.append(int(gl.argmax()) == int(cl.argmax()))
    res = {"phase": "crosscheck", "layers": ["local", "global"],
           "prompt": 300, "decode_steps": 4, "max_abs_err": max(errs),
           "per_step_err": errs, "tolerance": tol, "argmax_agree": all(same)}
    log(json.dumps(res))
    check(max(errs) <= tol, f"cross-check: logits differ by {max(errs)}")
    check(all(same), "cross-check: argmax tokens differ")
    return res


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


# -- phase 3: the slice -------------------------------------------------------------

class FiniteLogits:
    """Model wrapper that folds ``isfinite(logits).all()`` of every prefill
    and decode into one device flag (read once at the end, no extra sync)."""

    def __init__(self, model):
        self.model, self.cfg, self.flag = model, model.cfg, None

    def _see(self, logits):
        f = torch.isfinite(logits).all()
        self.flag = f if self.flag is None else self.flag & f

    def prefill(self, *a, **kw):
        logits, cache = self.model.prefill(*a, **kw)
        self._see(logits)
        return logits, cache

    def decode(self, *a, **kw):
        logits, cache = self.model.decode(*a, **kw)
        self._see(logits)
        return logits, cache

    def init_cache(self, *a, **kw):
        return self.model.init_cache(*a, **kw)


def phase_serve(dev):
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import build
    from repro_torch.serve.engine import (EngineConfig, Request,
                                          ServingEngine, bucket_length)

    cfg = get("gemma3-1b")                     # full width, bf16
    model = FiniteLogits(build(cfg))
    params = model.model.init(torch.Generator(dev).manual_seed(0))
    n_params = sum(p.numel() for p in _leaves(params))
    ecfg = EngineConfig(slots=4, max_seq=2048, context=1024, chips=16.0)
    check(int(ecfg.chips * ecfg.tokens_per_chip_step) >= 1024,
          "budget must admit a 1024-token prompt")
    engine = ServingEngine(model, params, ecfg, device=dev)
    rng = np.random.default_rng(0)
    lengths = [100, 300, 700, 1000] * 2
    reqs = [Request(i, rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=16) for i, n in enumerate(lengths)]
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()

    decode_attention_cuda.launches = 0
    flash_attention_cuda.launches = 0
    step_ms = []
    t0 = time.perf_counter()
    while len(engine.completed) < len(reqs) and engine.steps < 500:
        engine.step()
        step_ms.append(1e3 * engine.last_step_s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode_attention": decode_attention_cuda.launches,
                "flash_attention": flash_attention_cuda.launches}

    check(len(engine.completed) == len(reqs), "not every request completed")
    for r in engine.completed:
        check(len(r.generated) == 16, f"request {r.rid}: "
              f"{len(r.generated)} tokens")
        check(all(0 <= t < cfg.vocab for t in r.generated),
              f"request {r.rid}: token out of vocab")
    check(bool(model.flag), "non-finite logits")
    check(launches["decode_attention"] == cfg.n_layers * engine.steps,
          f"decode launches {launches} vs {engine.steps} steps")
    check(launches["flash_attention"] == cfg.n_layers * len(reqs),
          f"flash launches {launches} vs {len(reqs)} prompts")

    prefill_ms = {}
    for n in (100, 300, 1000):
        b = bucket_length(n, ecfg.max_seq)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, b))).to(dev)
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            model.model.prefill(params, {"tokens": toks},
                                max_seq=ecfg.max_seq, length=n)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
        prefill_ms[str(b)] = statistics.median(times[1:])
    tokens = sum(len(r.generated) for r in engine.completed)
    res = {"phase": "serve", "model": cfg.name, "params": n_params,
           "dtype": cfg.dtype, "requests": len(reqs),
           "prompt_lengths": lengths, "new_tokens_each": 16,
           "engine_steps": engine.steps, "tokens_generated": tokens,
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "decode_tokens_per_s": engine.tokens_out / wall,
           "decode_step_ms_median": statistics.median(step_ms),
           "decode_step_ms_min": min(step_ms),
           "prefill_ms_by_bucket": prefill_ms, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(json.dumps(res))
    return res, engine


def phase_trace(engine, steps=3):
    """Where a decode step's time goes: ``torch.profiler`` over a few steps
    of the phase-3 engine (its lanes now idle, which decode as before) and
    over one 1024-token prefill. Device busy time is the sum of the kernels'
    self time; the rest of the wall clock the device idles."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):          # the attribute's name moved in torch 2.4
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def window(label, fn, n):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0) / n
        ka = prof.key_averages()
        busy = sum(dev_us(e) for e in ka) / n
        top_dev = sorted(ka, key=dev_us, reverse=True)[:8]
        top_cpu = sorted(ka, key=lambda e: e.self_cpu_time_total,
                         reverse=True)[:8]
        return {"window": label, "wall_ms": wall_us / 1e3,
                "device_busy_ms": busy / 1e3,
                "device_idle_share": max(0.0, 1.0 - busy / wall_us),
                "top_device_ms": [[e.key, dev_us(e) / n / 1e3, e.count // n]
                                  for e in top_dev],
                "top_host_self_ms": [[e.key, e.self_cpu_time_total / n / 1e3,
                                      e.count // n] for e in top_cpu]}

    toks = torch.zeros((1, 1024), dtype=torch.long, device=engine.device)
    res = {"phase": "trace",
           "decode_step": window("decode_step", engine.step, steps),
           "prefill_1024": window("prefill_1024", lambda: engine.model.prefill(
               engine.params, {"tokens": toks}, max_seq=engine.cfg.max_seq,
               length=1000), 1)}
    log(json.dumps(res))
    return res


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# -- the summary ------------------------------------------------------------------

def kernel_entry(rows, name, case, launches, source, replaces):
    """One ``kernels`` entry, timed on the case that most launches of the
    path resemble (bf16, local layers: 22 of 26), error the worst bf16."""
    rep = next(r for r in rows if r["kernel"] == name and r["case"] == case
               and r["dtype"] == "bfloat16")
    ms, by = rep["bound"]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["kernel"] == name
                               and r["dtype"] == "bfloat16"),
            "max_abs_err_fp32": max(r["max_abs_err"] for r in rows
                                    if r["kernel"] == name
                                    and r["dtype"] == "float32"),
            "case": case, "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": ms, "bound_by": by, "library_ms": rep["library_ms"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the full report (JSON) here")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this script needs an NVIDIA "
            "GPU")
        return 2
    if not (SRC / "repro_torch").is_dir():
        log(f"chip_smoke: {SRC / 'repro_torch'} not found; run it from a "
            "checkout of the repository")
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    from repro_torch.kernels import _build
    t = time.perf_counter()
    build_dir = _build.build_all()
    build = {"phase": "build", "dir": str(build_dir),
             "sources": [s.name for s in _build.sources()],
             "seconds": time.perf_counter() - t}
    print(json.dumps(build), flush=True)

    rows = phase_kernels(dev)
    print(json.dumps({"phase": "kernels", "cases": rows}), flush=True)
    cross = phase_crosscheck(dev)
    print(json.dumps(cross), flush=True)
    serve, engine = phase_serve(dev)
    print(json.dumps(serve), flush=True)
    trace = phase_trace(engine)
    print(json.dumps(trace), flush=True)

    kernels = {"kernels": [
        kernel_entry(rows, "decode_attention", "local",
                     serve["launches"]["decode_attention"],
                     "src/repro_torch/kernels/csrc/decode_attention.cu",
                     "src/repro/kernels/decode_attention.py:70"),
        kernel_entry(rows, "flash_attention", "S1024_w512",
                     serve["launches"]["flash_attention"],
                     "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:79")]}
    print(json.dumps(kernels), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"gpu": smi, "device": device, "build": build, "kernel_cases": rows,
             "crosscheck": cross, "serve": serve, "trace": trace, **kernels},
            indent=1))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
