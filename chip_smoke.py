#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out report.json]

Phase 0 builds every CUDA kernel from src/repro_torch/kernels/csrc with nvcc
(sm_90a), one nvcc per source, all at once, and reports each kernel's
registers and spills as ptxas gave them.

Phase 1 holds each kernel against its plain PyTorch version on the card, on
the shapes the serving path gives it, in float32 (tolerance 2e-5) and bf16
(5e-2), the tolerances of tests/test_kernels.py; the flash kernel also on
8 query heads to a kv head and on a 17-token prompt. Each flash case
records its variant: bf16 runs the wgmma kernel ("wgmma",
flash_attention_sm90.cu), float32 the split-TF32 one ("tf32x3",
flash_attention.cu, three TF32 tensor-core products for each float32
one). It times the kernel, the
plain version and ``scaled_dot_product_attention`` (the library yardstick,
which the port never calls): device time (CUDA events around calls queued
behind a device spin, so the host does not pace them) and call time
(``call_ms``: the same events around calls queued as a caller queues them,
host overhead included where the host is the slower side). It computes
each kernel's bound: the larger of the bytes it must move over 3.35 TB/s
and its flops over the peak rate for its type (989 TFLOP/s bf16, 67
TFLOP/s float32), from the H100 SXM data sheet. Each decode case also
counts, with ``torch.profiler``, the CUDA kernels one call launches
(``kernels_per_call``): it must be 1 (the cluster combines its partials
inside the one launch). Each float32 flash case counts them too: 1, or 2
where the kernel splits the kv range (``kv_splits`` > 1) and a merge
kernel follows; and it records a second bound beside the float32 FMA one,
the tensor-core time of the work the kernel issues (3 x flops over
494.7 TFLOP/s dense TF32, ``bound_tf32x3``).

Phase 2 cross-checks gemma3-1b at full width (d_model 1152, vocab 262144),
cut to 2 layers (one local, one global), in float32: a 300-token prefill
and 4 decode steps on the card against the same weights on the CPU; the
prefill must launch the float32 (split-TF32) flash kernel once a layer.

Phase 3 is the slice: gemma3-1b at full width in bf16, random weights from
a seeded generator, behind the continuous-batching ServingEngine (4 slots,
max_seq 2048, context 1024), serving 8 requests of 100 to 1000 prompt
tokens and 16 new tokens each. Launch counters are zeroed just before and
read just after; every layer of every decode step and every prefill must
have gone through the kernels, every flash launch through the bf16
wgmma kernel. A profiler window over a few decode steps
and one prefill then says where the time goes (after the counters are
read).

Slice B, the RASK decide cycle (src/repro_torch/core), adds:

Phase "rask_kernels" holds the objective's forward and backward kernels
against their plain versions (1e-5 relative and absolute, float32) on the
|S| = 3/9/27 layouts of the paper's QR/CV/PC services (1, 3 and 9
replicas), with models fitted by the port's own agent on the card, at
K = 6 starts and K = 7. It times each kernel, its plain version and an
empty kernel (the practical floor of one launch) like phase 1, and
computes each kernel's bound from the bytes and operations of this run's
tables (real terms only). No single PyTorch call computes this function,
so the library column is null. Each row also records its device time over
the empty launch's (``ms_over_empty_launch``) and, from the profiler, the
CUDA kernels one call launches (``kernels_per_call``, which must be 1).

Phase "autoscale" is the slice: E6's largest paper point, 9 services (3
replicas of QR/CV/PC) on one 24-core device under e3's load mix (QR
diurnal to 100 rps, CV diurnal to 10 rps, PC constant 50), 600 simulated
seconds with xi = 20, the agent deciding on the card. Launch counters are
zeroed just before and read just after; every solve must have gone
through both kernels (one forward and 32 backward launches a decide at
the default budget: each of the 32 ascent steps takes the backward kernel
alone, through ``ops.rask_objective_vjp``, and the forward scores the
finals). No plan may
exceed the capacity, and the post-exploration mean fulfillment must be
within 0.03 of the same scenario run by the port on the CPU, whose random
starts are drawn from the same CUDA generator. One more steady decide runs
under ``torch.cuda.set_sync_debug_mode("warn")``, which reports every
synchronising call: only the final device-to-host copy is expected.

Phase "rask_crosscheck" then takes that agent's live stream state (the
Gram system built by the card's rank-k pushes, one a decide; at 600 s the
window of ~60 rows fits the 64-row ring, so no eviction or resync runs)
and holds it against an exact CPU rebuild from the training window (1e-5
relative). It runs one steady decide's fit and solve from that state on
the card and, copied, on the CPU, each through the agent's own ``_tail``
with the same warm start, load and random-start uniforms: the scores
agree to 1e-4 relative, each side's assignment scores within 1e-4 of the
other side's best under the other side's models, and both are feasible.

Phase "decide_timing" times the steady decide at |S| = 3, 9 and 27 (the
median and p90 of ``DecisionInfo.runtime_s`` over the solved cycles after
the first), and phase "rask_trace" runs ``torch.profiler`` over 3 steady
decides at |S| = 9: device busy ms, idle share and launch calls a decide,
and the launches of each RASK kernel a decide from their counters.

Slice C, mamba2-370m served by the port (src/repro_torch/models/ssm.py),
adds:

Phase "ssd_kernels" holds the SSD scan kernel against its plain version
on the card at the slice's shapes (b = 1, 32 heads of 64, state 128,
chunk 128, l = 128, 384 and 1024) plus b = 2 with a non-zero initial
state (l = 256 and 768), in float32 (test_ssd_sweep's atol 1e-4, rtol
1e-3) and bf16 (1e-1), and times the kernel and the plain version like
phase 1; each case records its variant (bf16 on the tensor cores, float32
on the CUDA cores). A profiler window over 20 calls at l = 1024 in bf16
splits a call into its three launches (chunk_state, state_passing,
chunk_scan). The
bound is the larger of the bytes moved (x, dt, A, B, C, y, the initial
and final states) over 3.35 TB/s and the flops of the chunked algorithm
on these shapes (C B^T once per chunk, the lower triangles only) over the
dtype's peak. No single PyTorch call computes the scan, so the library
column is null.

Phase "ssm_crosscheck" runs mamba2-370m at full width (d_model 1024,
vocab 50280), cut to 2 layers, in float32: a 300-token prefill (padded to
384 inside each layer: three chunks, two carries and a dt = 0 tail) and 4
decode steps on the card against the same weights on the CPU.

Phase "ssm_serve" is the slice: mamba2-370m at full width in bf16,
random weights from a seeded generator, behind the ServingEngine (4
slots, max_seq 2048, context 1024, exact-length prefill), serving 8
requests with prompts {100, 300, 700, 1000} x 2 and 16 new tokens each.
Launch counters are zeroed just before and read just after: the SSD
kernel must have run once per layer per admitted prompt, and no plain
version of a kernel may have run on the card. Phase "ssm_trace" runs
``profile_window`` over 3 decode steps of that engine and one 1000-token
prefill.

Prints the card's name and power limit, one JSON line per phase, a
``{"kernels": [...]}`` line (one entry a kernel, the float32 flash kernel
its own), and as the last line
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
TF32_FLOPS = 494.7e12            # dense TF32 tensor cores, H100 SXM
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
    so the calls run back to back and the events time the card alone. The
    device's launch queue holds about a thousand kernels: a plain version
    of many small launches fills it behind the spin and blocks the host, so
    the device loop then times fewer calls."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    call, queued = _events_ms(fns, iters)
    per_ms, _ = _events_ms([lambda: torch.cuda._sleep(1 << 20)], 1)
    cycles_per_ms = (1 << 20) / per_ms
    while True:
        spin_ms = 2e3 * queued + 1.0
        device, queued_now = _events_ms(fns, iters,
                                        int(spin_ms * cycles_per_ms))
        if 1e3 * queued_now < spin_ms:   # every call was queued in time
            return device, call
        if iters == 1:
            raise RuntimeError("the host could not queue the timed calls "
                               "ahead of the device")
        iters = max(1, iters // 2)
        _, queued = _events_ms(fns, iters)


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


_LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchKernelExC")


def kernels_per_call(fn, calls=10):
    """CUDA kernels one call of ``fn`` launches, counted by
    ``torch.profiler`` over ``calls`` calls after a warm one: the launch
    API calls it records a call (every launch, whatever its kind), and the
    names of the kernels the device ran (the device side may drop an
    event now and then, so it names and does not count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.device_type == DeviceType.CPU
                   and e.key in _LAUNCH_KEYS)
    names = sorted(e.key for e in events if e.device_type != DeviceType.CPU
                   and not e.key.startswith(("Memcpy", "Memset")))
    return launches / calls, names


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
    (window 512) and global (no window); then two edges the bf16 kernel
    packs differently: 8 query heads on 1 kv head (8 heads of 8 positions
    a CTA) and two rows of a 17-token prompt (S < 64)."""
    g = torch.Generator(dev).manual_seed(12)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    out = []
    for S in (128, 512, 1024):
        for window in (512, 0):
            out.append((f"S{S}_w{window}", randn(1, 4, S, 256),
                        randn(1, 1, S, 256), randn(1, 1, S, 256), window))
    out.append(("G8_S200_w0", randn(1, 8, 200, 64), randn(1, 1, 200, 64),
                randn(1, 1, 200, 64), 0))
    out.append(("B2_S17_w8", randn(2, 2, 17, 64), randn(2, 1, 17, 64),
                randn(2, 1, 17, 64), 8))
    return out


def phase_kernels(dev):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     kv_splits)

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
            row["kernels_per_call"], row["kernel_names"] = \
                kernels_per_call(lambda: decode_attention_cuda(
                    q, k, v, length, start))
            check(row["kernels_per_call"] == 1,
                  f"decode {name} {dname}: {row['kernels_per_call']} "
                  f"kernels a call ({row['kernel_names']}), want 1")
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
                   "variant": "wgmma" if dtype == torch.bfloat16
                   else "tf32x3", "max_abs_err": err,
                   "bound": bound_ms(nbytes, flops, dname)}

            def call():
                return flash_attention_cuda(q, k, v, causal=True,
                                            window=window)
            row["ms"], row["call_ms"] = time_ms([call], 20)
            if dtype == torch.float32:
                # the tensor cores' time for the products the kernel issues
                t_bytes = nbytes / HBM_BYTES_PER_S
                t_ops = 3 * flops / TF32_FLOPS
                row["bound_tf32x3"] = [1e3 * max(t_bytes, t_ops),
                                       "bytes" if t_bytes >= t_ops
                                       else "operations"]
                row["kv_splits"] = kv_splits(q, k, causal=True,
                                             window=window)
                row["kernels_per_call"], row["kernel_names"] = \
                    kernels_per_call(call)
                want_kernels = 2 if row["kv_splits"] > 1 else 1
                check(row["kernels_per_call"] == want_kernels,
                      f"flash {name} float32: {row['kernels_per_call']} "
                      f"kernels a call ({row['kernel_names']}), want "
                      f"{want_kernels}")
            row["plain_ms"], row["plain_call_ms"] = time_ms([
                lambda: ref.flash_attention_reference(
                    q, k, v, causal=True, window=window)], 10)
            kk, vv = k.expand(B, H, T, D), v.expand(B, H, T, D)   # KH = 1
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
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     reset_launches)
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
    cpu_params = _to_cpu(params)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (1, 300))
    reset_launches()
    gl, gc = model.prefill(params, {"tokens": torch.from_numpy(toks).to(dev)},
                           max_seq=512)
    launches = dict(flash_attention_cuda.variant_launches)
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
           "per_step_err": errs, "tolerance": tol, "argmax_agree": all(same),
           "flash_launches": launches}
    log(json.dumps(res))
    check(launches == {"wgmma": 0, "tf32x3": cfg.n_layers},
          f"cross-check: float32 prefill flash launches {launches}")
    check(max(errs) <= tol, f"cross-check: logits differ by {max(errs)}")
    check(all(same), "cross-check: argmax tokens differ")
    return res


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


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

    @property
    def supports_padded_prefill(self):
        return self.model.supports_padded_prefill


def phase_serve(dev):
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     reset_launches)
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
    reset_launches()
    step_ms = []
    t0 = time.perf_counter()
    while len(engine.completed) < len(reqs) and engine.steps < 500:
        engine.step()
        step_ms.append(1e3 * engine.last_step_s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode_attention": decode_attention_cuda.launches,
                "flash_attention": flash_attention_cuda.launches}
    flash_variants = dict(flash_attention_cuda.variant_launches)

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
    check(flash_variants == {"wgmma": launches["flash_attention"],
                             "tf32x3": 0},
          f"bf16 flash launches outside the wgmma kernel: "
          f"{flash_variants}")

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
           "flash_variant_launches": flash_variants,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(json.dumps(res))
    return res, engine



def profile_window(label, fn, n):
    """``torch.profiler`` over ``n`` calls of ``fn`` (after one warm call).

    Device busy time is the summed duration of the device's own events
    (kernels, copies, memsets). A CPU op's device time repeats the kernels
    it launched, so CPU ops are left out of that sum; the rest of the wall
    clock the device idles. Also counts the kernel launch calls a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):          # the attribute's name moved in torch 2.4
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

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
    dev = [e for e in ka if e.device_type != DeviceType.CPU]
    host = [e for e in ka if e.device_type == DeviceType.CPU]
    busy = sum(dev_us(e) for e in dev) / n
    top_dev = sorted(dev, key=dev_us, reverse=True)[:8]
    top_cpu = sorted(host, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:8]
    return {"window": label, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy / wall_us),
            "launches": sum(e.count for e in host
                            if e.key in _LAUNCH_KEYS) / n,
            "top_device_ms": [[e.key, dev_us(e) / n / 1e3, e.count / n]
                              for e in top_dev],
            "top_host_self_ms": [[e.key, e.self_cpu_time_total / n / 1e3,
                                  e.count / n] for e in top_cpu]}


def phase_trace(engine, name="trace", steps=3):
    """Where a decode step's time goes: ``profile_window`` over a few steps
    of a serving phase's engine (its lanes now idle, which decode as
    before) and over one 1000-token prompt's prefill (padded to the 1024
    bucket where the model takes padded prompts)."""
    padded = engine.model.supports_padded_prefill
    toks = torch.zeros((1, 1024 if padded else 1000), dtype=torch.long,
                       device=engine.device)
    length = 1000 if padded else None
    res = {"phase": name,
           "decode_step": profile_window("decode_step", engine.step, steps),
           f"prefill_{toks.shape[1]}": profile_window(
               f"prefill_{toks.shape[1]}", lambda: engine.model.prefill(
                   engine.params, {"tokens": toks},
                   max_seq=engine.cfg.max_seq, length=length), 1)}
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


# -- slice B: the RASK decide cycle -------------------------------------------------

RASK_SOURCE = "src/repro_torch/kernels/csrc/rask_objective.cu"
RASK_TOL = 1e-5           # float32 on both sides; sums in another order


def _rask_env(replicas, patterns=None, seed=0):
    from repro_torch.env import EdgeEnvironment, paper_profiles
    return EdgeEnvironment(list(paper_profiles().values()),
                           {"cores": 8.0 * replicas}, patterns=patterns,
                           replicas=replicas, seed=seed)


def _rask_agent(env, dev, cls=None, seed=0):
    from repro_torch.core import RASKAgent, RaskConfig
    from repro_torch.env import paper_knowledge
    cls = cls or RASKAgent
    return cls(env.platform, paper_knowledge(), RaskConfig(xi=20), seed=seed,
               device=dev)


def _steady_ms(hist):
    """Median and p90 ms of the solved decides after the first."""
    import numpy as np
    ms = [1e3 * h.runtime_s for h in hist if not h.explored][1:]
    return {"decides": len(ms), "median_ms": statistics.median(ms),
            "p90_ms": float(np.percentile(ms, 90)), "min_ms": min(ms)}


def phase_decide_timing(dev):
    """The paper triple with 1, 3 and 9 replicas on 8 cores each, default
    loads, 400 s (20 explored + 20 solved cycles) on the card. Returns the
    timings and the agents (their fitted models feed rask_kernels)."""
    res, agents = {"phase": "decide_timing"}, {}
    for replicas in (1, 3, 9):
        env = _rask_env(replicas)
        agent = _rask_agent(env, dev)
        t0 = time.perf_counter()
        hist = env.run(agent, duration_s=400.0)
        row = _steady_ms(hist)
        row.update(services=3 * replicas, dim=agent.problem.dim,
                   wall_s=time.perf_counter() - t0,
                   first_solve_compile_s=[h.compile_s for h in hist
                                          if not h.explored][0])
        res[f"S{3 * replicas}"] = row
        agents[3 * replicas] = (env, agent)
    log(json.dumps(res))
    return res, agents


def _objective_args(env, agent, K, seed):
    """The objective's inputs as the solver gives them: the agent's tables
    and fitted models, K projected random candidates, the current load."""
    import numpy as np
    rng = np.random.default_rng(seed)
    dev = agent.device
    p, sm = agent.problem, agent.stacked
    A = np.stack([p.random_assignment(rng, agent.capacity)
                  for _ in range(K)])
    rps = agent._rps_vector(agent.platform.window_states(env.t - 5, env.t))
    t = p.tables
    args = (torch.from_numpy(A).to(dev), t.rel_gather, sm.w, sm.exponents,
            sm.term_mask, sm.x_scale, t.slo_kind, t.slo_service,
            t.slo_weight, t.slo_target, t.slo_pidx, t.slo_ridx,
            torch.from_numpy(rps).to(dev))
    return args, dict(n_services=len(p.specs), max_degree=sm.max_degree)


def _objective_work(args, n_services, backward):
    """(bytes, flops) one call needs on these inputs: every input read once
    and the output written once; the flops of the real terms only (padded
    terms have mask 0) — features, powers, term products, phi, sums."""
    A, rel, w, E, tm = args[:5]
    K, D = A.shape
    R, T, F = E.shape
    Q, S = args[6].shape[0], n_services
    nbytes = 4 * sum(t.numel() for t in args) + 4 * K * (D if backward else S)
    if backward:
        nbytes += 4 * K * S                              # the cotangent
    real = (tm > 0)
    n_real = int(real.sum())
    powers = int((E * real[..., None]).sum())             # x^e products
    fwd = R * F + powers + n_real * (F + 2) + 5 * Q + Q
    if not backward:
        return nbytes, K * fwd
    bwd = fwd + powers + n_real * (F * (F - 1) + 4 * F + 1) + 6 * Q \
        + 2 * R * F + Q + R * F
    return nbytes, K * bwd


def phase_rask_kernels(dev, agents):
    from repro_torch.kernels import ref
    from repro_torch.kernels.rask_objective import (
        empty_launch_cuda, rask_objective_backward_cuda,
        rask_objective_forward_cuda)

    rows = []
    for S, (env, agent) in sorted(agents.items()):
        for K in (6, 7):
            args, kw = _objective_args(env, agent, K, seed=S + K)
            A = args[0]
            g = torch.Generator(dev).manual_seed(S + K)
            ct = torch.randn((K, S), generator=g, device=dev)
            fwd = rask_objective_forward_cuda(*args, n_services=S)
            bwd = rask_objective_backward_cuda(A, ct, *args[1:],
                                               n_services=S)
            want_f = ref.rask_objective_reference(*args, **kw)
            want_b = ref.rask_objective_grad(A, ct, *args[1:], **kw)
            torch.cuda.synchronize()
            for name, got, want, backward in (
                    ("rask_objective", fwd, want_f, False),
                    ("rask_objective_grad", bwd, want_b, True)):
                err = (got - want).abs().max().item()
                bar = RASK_TOL * (1.0 + want.abs().max().item())
                check(bool(torch.isfinite(got).all()),
                      f"{name} S{S} K{K}: non-finite output")
                check(err <= bar, f"{name} S{S} K{K}: error {err} > {bar}")
                nbytes, flops = _objective_work(args, S, backward)
                row = {"kernel": name, "case": f"S{S}_K{K}", "K": K,
                       "services": S, "dim": A.shape[1],
                       "relations": args[3].shape[0],
                       "terms": args[3].shape[1], "slos": args[6].shape[0],
                       "max_abs_err": err, "tolerance": bar,
                       "bytes": nbytes, "flops": flops,
                       "bound": bound_ms(nbytes, flops, "float32")}
                if backward:
                    def call():
                        return rask_objective_backward_cuda(
                            A, ct, *args[1:], n_services=S)
                    row["plain_ms"], row["plain_call_ms"] = time_ms([
                        lambda: ref.rask_objective_grad(A, ct, *args[1:],
                                                        **kw)], 50)
                else:
                    def call():
                        return rask_objective_forward_cuda(
                            *args, n_services=S)
                    row["plain_ms"], row["plain_call_ms"] = time_ms([
                        lambda: ref.rask_objective_reference(*args, **kw)],
                        50)
                row["ms"], row["call_ms"] = time_ms([call], 200)
                row["kernels_per_call"], row["kernel_names"] = \
                    kernels_per_call(call)
                check(row["kernels_per_call"] == 1,
                      f"{name} S{S} K{K}: {row['kernels_per_call']} kernels "
                      f"a call ({row['kernel_names']}), want 1")
                row["library_ms"] = None     # no single PyTorch call
                rows.append(row)
                log(f"{name} S{S} K{K}: {row}")
    empty_ms, empty_call_ms = time_ms([lambda: empty_launch_cuda(dev)], 200)
    for row in rows:
        row["ms_over_empty_launch"] = row["ms"] / empty_ms
    res = {"phase": "rask_kernels", "cases": rows,
           "empty_launch_ms": empty_ms, "empty_launch_call_ms": empty_call_ms}
    log(json.dumps({"empty_launch_ms": empty_ms,
                    "empty_launch_call_ms": empty_call_ms}))
    return res


def phase_rask_crosscheck(env, agent):
    """One steady decide's fit + solve at |S| = 9, card and CPU, from the
    autoscale agent's live stream state (the card's rank-k pushes, copied
    to the CPU), its warm start, the current
    load and the same injected uniforms, each through the agent's own
    ``_tail``. The live accumulators are also held against an exact CPU
    rebuild from the training window, and each side's assignment is scored
    by the other side's models."""
    import copy

    import numpy as np

    from repro_torch.core.regression import BatchedFitPlan, StreamState
    from repro_torch.core.solver import SolverProblem, score_candidates

    cfg, cpu = agent.cfg, torch.device("cpu")
    live = agent._stream["state"]
    data = agent._collect_fit_data()
    rows = [len(Y) for _, Y in data]
    check(max(rows) <= agent._row_capacity,
          f"rask_crosscheck: window {max(rows)} outgrew the ring")
    relations = [dict(n_features=len(f), degree=agent._degree(sid),
                      x_scale=scale)
                 for sid, _, f, scale in agent._rel_static]
    cpu_plan = BatchedFitPlan(relations, agent._row_capacity,
                              ridge=cfg.ridge, device=cpu)
    exact = cpu_plan.stream_rebuild(data)
    acc_err = {k: float((getattr(live, k).cpu() - getattr(exact, k)).abs()
                        .amax() / getattr(exact, k).abs().amax().clamp(
                            min=1e-30)) for k in ("gram", "xty")}

    x0 = torch.from_numpy(agent._cached_x)
    rps = torch.from_numpy(
        agent._rps_vector(agent.platform.window_states(env.t - 5, env.t)))
    u = torch.from_numpy(np.random.default_rng(7).random(
        (cfg.pgd_starts - 3, agent.problem.dim)).astype(np.float32))
    sides = {"card": (agent, agent._fit_plan, live),
             "cpu": (None, cpu_plan, StreamState(*(t.cpu() for t in live)))}
    out = {}
    for key, (src, plan, state) in sides.items():
        twin = copy.copy(agent)
        if src is None:
            twin.device = cpu
            twin.problem = SolverProblem(agent.problem.specs, device=cpu)
            twin._gen = torch.Generator(cpu)
        where = twin.device
        twin._start_uniforms = lambda seed, where=where: u.to(where)
        sm = plan.stacked(plan.stream_fit_arrays(state))
        res = twin._tail(sm, x0.to(where), 0, rps.to(where)).cpu().numpy()
        d = agent.problem.dim
        out[key] = (res[:d], float(res[2 * d]), twin.problem, sm)

    # each side's assignment under the other side's models
    cross = {}
    for key, other in (("card", "cpu"), ("cpu", "card")):
        _, _, prob, sm = out[other]
        a = torch.from_numpy(out[key][0][None]).to(sm.w.device)
        cross[key] = float(score_candidates(a, prob.tables, sm,
                                            rps.to(sm.w.device),
                                            len(prob.specs))[0])
    p = agent.problem
    feasible = {}
    for k, (a, *_) in out.items():
        feasible[k] = bool(np.all(a >= p.lower - 1e-5)
                           and np.all(a <= p.upper + 1e-5)
                           and a[p.resource_mask].astype(np.float64).sum()
                           <= agent.capacity)

    def rel(x, y):
        return abs(x - y) / max(abs(y), 1e-12)

    s_gpu, s_cpu = out["card"][1], out["cpu"][1]
    res = {"phase": "rask_crosscheck", "services": len(p.specs),
           "window_rows": rows, "stream_pushes": agent._stream["pushes"],
           "accumulator_rel_err": acc_err, "accumulator_tolerance": 1e-5,
           "score_card": s_gpu, "score_cpu": s_cpu,
           "score_rel_diff": rel(s_gpu, s_cpu),
           "card_assignment_cpu_score": cross["card"],
           "cpu_assignment_card_score": cross["cpu"],
           "cross_score_rel_diff": max(rel(cross["card"], s_cpu),
                                       rel(cross["cpu"], s_gpu)),
           "tolerance": 1e-4,
           "assignment_max_abs_diff": float(np.abs(out["card"][0]
                                                   - out["cpu"][0]).max()),
           "feasible": feasible}
    log(json.dumps(res))
    check(max(acc_err.values()) <= 1e-5,
          f"rask_crosscheck: live accumulators vs rebuild {acc_err}")
    check(res["score_rel_diff"] <= 1e-4,
          f"rask_crosscheck: scores {s_gpu} vs {s_cpu}")
    check(res["cross_score_rel_diff"] <= 1e-4,
          f"rask_crosscheck: assignments score apart {cross}")
    check(all(feasible.values()), f"rask_crosscheck: infeasible {feasible}")
    return res


def _e3_mix():
    from repro_torch.env import constant, diurnal
    return {"qr-detector": diurnal(100.0), "cv-analyzer": diurnal(10.0),
            "pc-visualizer": constant(50.0)}


def phase_autoscale(dev):
    import warnings

    import numpy as np

    from repro_torch.core import RASKAgent
    from repro_torch.kernels.rask_objective import (
        rask_objective_backward_cuda, rask_objective_forward_cuda)

    seconds, replicas, cap = 600.0, 3, 24.0
    env = _rask_env(replicas, _e3_mix())
    agent = _rask_agent(env, dev)
    torch.cuda.synchronize()
    rask_objective_forward_cuda.launches = 0
    rask_objective_backward_cuda.launches = 0
    t0 = time.perf_counter()
    hist = env.run(agent, duration_s=seconds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rask_objective": rask_objective_forward_cuda.launches,
                "rask_objective_grad": rask_objective_backward_cuda.launches}

    solved = [h for h in hist if not h.explored]
    n = len(solved)
    check(n == len(hist) - 20, f"autoscale: {n} solved of {len(hist)}")
    steps = agent.cfg.pgd_iters        # one backward a step, one scoring
    check(launches["rask_objective"] == n,
          f"autoscale: forward launches {launches} for {n} solves")
    check(launches["rask_objective_grad"] == steps * n,
          f"autoscale: backward launches {launches} for {n} solves")
    worst = max(sum(v.get("cores", 0.0) for v in h.receipt.applied().values())
                for h in hist)
    check(worst <= cap + 1e-6, f"autoscale: {worst} cores of {cap}")
    post = float(np.mean([h.fulfillment for h in solved]))

    # the same scenario on the CPU, its starts drawn from the same CUDA
    # generator stream as the card's agent
    class CudaStarts(RASKAgent):
        def _start_uniforms(self, seed):
            g = torch.Generator(dev).manual_seed(seed)
            self._gen.manual_seed(seed)
            return torch.rand((self.cfg.pgd_starts - 3, self.problem.dim),
                              generator=g, device=dev).cpu()

    cpu_env = _rask_env(replicas, _e3_mix())
    cpu_agent = _rask_agent(cpu_env, torch.device("cpu"), cls=CudaStarts)
    cpu_hist = cpu_env.run(cpu_agent, duration_s=seconds)
    cpu_post = float(np.mean([h.fulfillment for h in cpu_hist
                              if not h.explored]))

    # one more steady decide, every synchronising call reported
    obs = agent.observe(env.t)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            agent.decide(obs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # one warning a synchronising call; the mode's own notice is not one
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "called a synchronizing" in str(w.message)]

    res = {"phase": "autoscale", "services": 3 * replicas, "cores": cap,
           "seconds": seconds, "xi": 20, "cycles": len(hist),
           "solved": n, "launches": launches,
           "kernel_launches_per_decide": {k: v / n for k, v in
                                          launches.items()},
           "decide": _steady_ms(hist), "wall_s": wall,
           "post_explore_fulfillment": post,
           "post_explore_fulfillment_cpu": cpu_post,
           "fulfillment_gap": abs(post - cpu_post), "tolerance": 0.03,
           "max_cores_applied": worst, "syncs_in_one_decide": len(syncs),
           "sync_messages": syncs[:4],
           "first_solve_compile_s": solved[0].compile_s}
    log(json.dumps(res))
    check(abs(post - cpu_post) <= 0.03,
          f"autoscale: fulfillment {post} on the card vs {cpu_post} on CPU")
    check(len(syncs) <= 1, f"autoscale: {len(syncs)} syncs in one decide")
    return res, env, agent


def phase_rask_trace(env, agent, decides=3):
    """``profile_window`` over a few steady decides of the autoscale agent
    (after its counters were read): device busy ms and launch calls a
    decide, and each RASK kernel's launches a decide from its counter."""
    from repro_torch.kernels.rask_objective import (
        rask_objective_backward_cuda, rask_objective_forward_cuda)
    obs = iter([agent.observe(env.t) for _ in range(decides + 1)])
    rask_objective_forward_cuda.launches = 0
    rask_objective_backward_cuda.launches = 0
    window = profile_window("decide", lambda: agent.decide(next(obs)),
                            decides)
    runs = decides + 1                    # profile_window's warm call too
    res = {"phase": "rask_trace", "services": len(agent.services),
           "decides": decides, **window,
           "kernel_launches_per_decide": {
               "rask_objective": rask_objective_forward_cuda.launches / runs,
               "rask_objective_grad":
                   rask_objective_backward_cuda.launches / runs}}
    log(json.dumps(res))
    return res


def rask_entry(kernels, name, launches, replaces):
    """One ``kernels`` entry: timed on the main path's shape (|S| = 9,
    K = 6), error the worst of every case."""
    rows = [r for r in kernels["cases"] if r["kernel"] == name]
    rep = next(r for r in rows if r["case"] == "S9_K6")
    ms, by = rep["bound"]
    return {"name": name, "route": "cuda", "source": RASK_SOURCE,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "case": "S9_K6", "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": ms, "bound_by": by, "library_ms": None,
            "call_ms": rep["call_ms"],
            "kernels_per_call": rep["kernels_per_call"],
            "empty_launch_ms": kernels["empty_launch_ms"],
            "ms_over_empty_launch": rep["ms_over_empty_launch"]}


# -- slice C: mamba2-370m -----------------------------------------------------------

SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
SSD_TOL = {"float32": dict(atol=1e-4, rtol=1e-3),     # test_ssd_sweep's
           "bfloat16": dict(atol=1e-1, rtol=1e-1)}


def ssd_cases(dev, dtype):
    """The scan's inputs at the slice's shapes (32 heads of 64, state 128,
    chunk 128), with test_ssd_sweep's distributions: the prompt lengths of
    phase "ssm_serve" rounded up to the chunk, and b = 2 with a non-zero
    initial state (two and six chunks)."""
    g = torch.Generator(dev).manual_seed(13)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    out = []
    for b, l, with_state in ((1, 128, False), (1, 384, False),
                             (1, 1024, False), (2, 256, True),
                             (2, 768, True)):
        h, p, n = 32, 64, 128
        args = [randn(b, l, h, p) * 0.5,
                torch.nn.functional.softplus(randn(b, l, h)),
                -torch.exp(randn(h) * 0.3),
                randn(b, l, n) * 0.5, randn(b, l, n) * 0.5]
        init = randn(b, h, p, n) * 0.5 if with_state else None
        name = f"b{b}_l{l}" + ("_init" if with_state else "")
        out.append((name, [t.to(dtype) for t in args],
                    None if init is None else init.to(dtype)))
    return out


def _ssd_work(args, init, chunk):
    """(bytes, flops) of one scan on these inputs: every input read once and
    both outputs written once; the chunked algorithm's flops with C B^T
    formed once per (row, chunk) (B and C are shared by the heads) and
    only the lower triangles of C B^T and of its product with x dt."""
    x, dt, A, B, C = args
    b, l, h, p = x.shape
    n = B.shape[-1]
    ck = min(chunk, l)
    nc = l // ck
    tri = ck * (ck + 1) // 2
    es = x.element_size()
    nbytes = es * (2 * x.numel() + dt.numel() + A.numel() + B.numel()
                   + C.numel() + b * h * p * n * (2 if init is not None
                                                  else 1))
    per_head = (2 * tri                  # L = exp(segsum), G = CB o L
                + 2 * tri * p            # G (x dt)
                + 2 * ck * p * n         # C S^T
                + 2 * ck * p * n         # (x dt decay)^T B
                + 2 * p * n              # S exp(cs_last) + ...
                + 3 * ck * p + 2 * ck)   # x dt, decay weights, scan
    flops = nc * b * (2 * tri * n + h * per_head)
    return nbytes, flops


def phase_ssd_kernels(dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_cuda

    rows, chunk = [], 128
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        tol = SSD_TOL[dname]
        for name, args, init in ssd_cases(dev, dtype):
            y, fin = ssd_cuda(*args, chunk=chunk, initial_state=init)
            wy, wfin = ref.ssd_reference(*args, chunk=chunk,
                                         initial_state=init)
            torch.cuda.synchronize()
            errs = {}
            for key, got, want in (("y", y, wy), ("final_state", fin, wfin)):
                got, want = got.float(), want.float()
                check(bool(torch.isfinite(got).all()),
                      f"ssd {name} {dname}: non-finite {key}")
                excess = ((got - want).abs() - tol["atol"]
                          - tol["rtol"] * want.abs()).max().item()
                errs[key] = (got - want).abs().max().item()
                check(excess <= 0, f"ssd {name} {dname}: {key} off by "
                      f"{errs[key]} (past atol {tol['atol']} + rtol "
                      f"{tol['rtol']} |plain| by {excess})")
            nbytes, flops = _ssd_work(args, init, chunk)
            row = {"kernel": "ssd_scan", "case": name, "dtype": dname,
                   "variant": "tensor_core" if dtype == torch.bfloat16
                   else "cuda_core",
                   "max_abs_err": max(errs.values()), "errors": errs,
                   "tolerance": tol, "bytes": nbytes, "flops": flops,
                   "bound": bound_ms(nbytes, flops, dname)}
            row["ms"], row["call_ms"] = time_ms([
                lambda: ssd_cuda(*args, chunk=chunk, initial_state=init)],
                20)
            row["plain_ms"], row["plain_call_ms"] = time_ms([
                lambda: ref.ssd_reference(*args, chunk=chunk,
                                          initial_state=init)], 10)
            row["library_ms"] = None     # no single PyTorch call
            rows.append(row)
            log(f"ssd {name} {dname}: {row}")
            if name == "b1_l1024" and dtype == torch.bfloat16:
                breakdown = ssd_launch_breakdown(
                    lambda: ssd_cuda(*args, chunk=chunk, initial_state=init))
    return {"phase": "ssd_kernels", "cases": rows,
            "launch_breakdown_b1_l1024_bf16": breakdown}


def ssd_launch_breakdown(fn, calls=20):
    """Device ms a call of each of the scan's kernels (chunk_state,
    state_passing, chunk_scan), from ``torch.profiler`` over ``calls``
    calls after a warm one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        for part in ("chunk_state", "state_passing", "chunk_scan"):
            if part in e.key:
                out[part] = {"ms": us / calls / 1e3,
                             "launches": e.count / calls}
    check(set(out) == {"chunk_state", "state_passing", "chunk_scan"},
          f"ssd profile: kernels {sorted(out)}")
    return out


def phase_ssm_crosscheck(dev):
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.models import build

    # 1e-3: float32 on the card (no TF32) and on the CPU, the same
    # arithmetic in other summation orders (the scan's kernel against its
    # plain version ~1e-6 relative); logits are O(1) after 2 layers, so
    # 1e-3 catches a wrong carry, pad, cast or conv window
    tol = 1e-3
    cfg = dataclasses.replace(get("mamba2-370m"), n_layers=2,
                              dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator(dev).manual_seed(3))
    cpu_params = _to_cpu(params)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, 300))
    gl, gc = model.prefill(params, {"tokens": torch.from_numpy(toks).to(dev)},
                           max_seq=512)
    cl, cc = model.prefill(cpu_params, {"tokens": torch.from_numpy(toks)},
                           max_seq=512)
    errs = [(gl.cpu() - cl).abs().max().item()]
    state_err = (gc["ssm"].cpu() - cc["ssm"]).abs().max().item()
    same = [int(gl.argmax()) == int(cl.argmax())]
    for _ in range(4):
        nxt = cl.argmax(-1)[:, None]
        gl, gc = model.decode(params, nxt.to(dev), gc)
        cl, cc = model.decode(cpu_params, nxt, cc)
        errs.append((gl.cpu() - cl).abs().max().item())
        same.append(int(gl.argmax()) == int(cl.argmax()))
    res = {"phase": "ssm_crosscheck", "model": cfg.name, "layers": 2,
           "d_model": cfg.d_model, "vocab": cfg.vocab, "prompt": 300,
           "scan_length": 384, "decode_steps": 4, "max_abs_err": max(errs),
           "per_step_err": errs, "prefill_state_err": state_err,
           "tolerance": tol, "argmax_agree": all(same)}
    log(json.dumps(res))
    check(max(errs) <= tol, f"ssm cross-check: logits differ by {max(errs)}")
    check(all(same), "ssm cross-check: argmax tokens differ")
    return res


class PlainOnCard:
    """Counts calls of the kernels' plain versions with CUDA tensors while
    active (``ops`` reaches them through the ``ref`` module)."""
    NAMES = ("ssd_reference", "flash_attention_reference",
             "decode_attention_reference", "rask_objective_reference",
             "rask_objective_grad")

    def __enter__(self):
        from repro_torch.kernels import ref
        self.ref, self.saved = ref, {}
        self.calls = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            fn = self.saved[name] = getattr(ref, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                if a[0].device.type == "cuda":
                    self.calls[_name] += 1
                return _fn(*a, **kw)
            setattr(ref, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ref, name, fn)


def phase_ssm_serve(dev):
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.kernels.ssd_scan import ssd_cuda
    from repro_torch.models import build
    from repro_torch.serve.engine import (EngineConfig, Request,
                                          ServingEngine)

    cfg = get("mamba2-370m")                   # full width, bf16
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
    torch.cuda.reset_peak_memory_stats()

    step_ms = []
    with PlainOnCard() as plain:
        ssd_cuda.launches = 0
        t0 = time.perf_counter()
        while len(engine.completed) < len(reqs) and engine.steps < 500:
            engine.step()
            step_ms.append(1e3 * engine.last_step_s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"ssd_scan": ssd_cuda.launches}
    admitted = len(engine.completed) + len(engine.active)

    check(len(engine.completed) == len(reqs), "not every request completed")
    for r in engine.completed:
        check(len(r.generated) == 16, f"request {r.rid}: "
              f"{len(r.generated)} tokens")
        check(all(0 <= t < cfg.vocab for t in r.generated),
              f"request {r.rid}: token out of vocab")
    check(bool(model.flag), "non-finite logits")
    check(launches["ssd_scan"] == cfg.n_layers * admitted,
          f"ssd launches {launches} vs {admitted} prompts")
    check(not any(plain.calls.values()),
          f"plain versions ran on the card: {plain.calls}")
    peak = torch.cuda.max_memory_allocated() / 1e9

    prefill_ms = {}
    for n in (100, 300, 700, 1000):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, n))).to(dev)
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            model.model.prefill(params, {"tokens": toks},
                                max_seq=ecfg.max_seq)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
        prefill_ms[str(n)] = statistics.median(times[1:])
    tokens = sum(len(r.generated) for r in engine.completed)
    res = {"phase": "ssm_serve", "model": cfg.name, "params": n_params,
           "dtype": cfg.dtype, "requests": len(reqs),
           "prompt_lengths": lengths, "new_tokens_each": 16,
           "prompts_admitted": admitted, "engine_steps": engine.steps,
           "tokens_generated": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "decode_tokens_per_s": engine.tokens_out / wall,
           "decode_step_ms_median": statistics.median(step_ms),
           "decode_step_ms_min": min(step_ms),
           "prefill_ms_by_length": prefill_ms, "launches": launches,
           "plain_calls_on_card": plain.calls, "peak_mem_gb": peak}
    log(json.dumps(res))
    return res, engine


# -- the summary ------------------------------------------------------------------

def kernel_entry(rows, kernel, case, launches, source, replaces,
                 dtype="bfloat16", name=None):
    """One ``kernels`` entry for ``kernel``'s ``dtype`` cases, timed on the
    case that most launches of the path resemble, error the worst case of
    that dtype."""
    mine = [r for r in rows if r["kernel"] == kernel and r["dtype"] == dtype]
    rep = next(r for r in mine if r["case"] == case)
    ms, by = rep["bound"]
    entry = {"name": name or kernel, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches, "dtype": dtype,
             "max_abs_err": max(r["max_abs_err"] for r in mine),
             "case": case, "ms": rep["ms"], "plain_ms": rep["plain_ms"],
             "bound_ms": ms, "bound_by": by,
             "library_ms": rep["library_ms"], "call_ms": rep["call_ms"]}
    if "kernels_per_call" in rep:           # counted for decode attention
        entry["kernels_per_call"] = rep["kernels_per_call"]
    return entry


def flash_fp32_entry(rows, launches):
    """The ``kernels`` entry of the float32 flash kernel: timed on the
    1024 bucket's local layer (window 512) with the global layer's numbers
    beside it, both bounds, and its CUDA kernels a call."""
    entry = kernel_entry(rows, "flash_attention", "S1024_w512", launches,
                         "src/repro_torch/kernels/csrc/flash_attention.cu",
                         "src/repro/kernels/flash_attention.py:79",
                         dtype="float32", name="flash_attention_fp32")
    mine = {r["case"]: r for r in rows if r["kernel"] == "flash_attention"
            and r["dtype"] == "float32"}
    entry["bound_tf32x3_ms"] = mine["S1024_w512"]["bound_tf32x3"][0]
    glob = mine["S1024_w0"]
    entry["S1024_w0"] = {
        "ms": glob["ms"], "plain_ms": glob["plain_ms"],
        "library_ms": glob["library_ms"], "bound_ms": glob["bound"][0],
        "bound_tf32x3_ms": glob["bound_tf32x3"][0],
        "kernels_per_call": glob["kernels_per_call"]}
    return entry


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
             "seconds": time.perf_counter() - t,
             "ptxas": _build.ptxas_usage(build_dir)}
    print(json.dumps(build), flush=True)

    rows = phase_kernels(dev)
    print(json.dumps({"phase": "kernels", "cases": rows}), flush=True)
    cross = phase_crosscheck(dev)
    print(json.dumps(cross), flush=True)
    serve, engine = phase_serve(dev)
    print(json.dumps(serve), flush=True)
    trace = phase_trace(engine)
    print(json.dumps(trace), flush=True)
    del engine

    timing, agents = phase_decide_timing(dev)
    print(json.dumps(timing), flush=True)
    rask_kernels = phase_rask_kernels(dev, agents)
    print(json.dumps(rask_kernels), flush=True)
    auto, auto_env, auto_agent = phase_autoscale(dev)
    print(json.dumps(auto), flush=True)
    rask_cross = phase_rask_crosscheck(auto_env, auto_agent)
    print(json.dumps(rask_cross), flush=True)
    rask_trace = phase_rask_trace(auto_env, auto_agent)
    print(json.dumps(rask_trace), flush=True)

    ssd_kernels = phase_ssd_kernels(dev)
    print(json.dumps(ssd_kernels), flush=True)
    ssm_cross = phase_ssm_crosscheck(dev)
    print(json.dumps(ssm_cross), flush=True)
    ssm_serve, ssm_engine = phase_ssm_serve(dev)
    print(json.dumps(ssm_serve), flush=True)
    ssm_trace = phase_trace(ssm_engine, name="ssm_trace")
    print(json.dumps(ssm_trace), flush=True)

    kernels = {"kernels": [
        # local layers: 22 of 26
        kernel_entry(rows, "decode_attention", "local",
                     serve["launches"]["decode_attention"],
                     "src/repro_torch/kernels/csrc/decode_attention.cu",
                     "src/repro/kernels/decode_attention.py:70"),
        kernel_entry(rows, "flash_attention", "S1024_w512",
                     serve["flash_variant_launches"]["wgmma"],
                     "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
                     "src/repro/kernels/flash_attention.py:79"),
        # float32 prompts (phase "crosscheck" prefills one)
        flash_fp32_entry(rows, cross["flash_launches"]["tf32x3"]),
        rask_entry(rask_kernels, "rask_objective",
                   auto["launches"]["rask_objective"],
                   "src/repro/kernels/rask_objective.py:79"),
        rask_entry(rask_kernels, "rask_objective_grad",
                   auto["launches"]["rask_objective_grad"],
                   "src/repro/kernels/rask_objective.py:135"),
        # the longest prompt of the slice, l = 1024
        kernel_entry(ssd_kernels["cases"], "ssd_scan", "b1_l1024",
                     ssm_serve["launches"]["ssd_scan"], SSD_SOURCE,
                     "src/repro/kernels/ssd_scan.py:79")]}
    print(json.dumps(kernels), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"gpu": smi, "device": device, "build": build, "kernel_cases": rows,
             "crosscheck": cross, "serve": serve, "trace": trace,
             "decide_timing": timing, "rask_kernels": rask_kernels,
             "rask_crosscheck": rask_cross, "autoscale": auto,
             "rask_trace": rask_trace, "ssd_kernels": ssd_kernels,
             "ssm_crosscheck": ssm_cross, "ssm_serve": ssm_serve,
             "ssm_trace": ssm_trace, **kernels},
            indent=1))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
