#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out report.json]

Phase 0 builds every CUDA kernel from src/repro_torch/kernels/csrc with nvcc
(sm_90a), one nvcc per source, all at once, and reports each kernel's
registers and spills as ptxas gave them.

Phase 1 holds each kernel against its plain PyTorch version on the card, on
the shapes the serving path gives it, in float32 (tolerance 2e-5) and bf16
(5e-2), the tolerances of tests/test_kernels.py; the flash kernel also on
8 query heads to a kv head and on a 17-token prompt; both also at e11's
shapes (a 64-slot cache of 4 rows and of 1 row; 13- and 32-token prompts). Each flash case
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

e11, the closed serving loop (src/repro_torch/serve, env/scenarios.py,
obs), adds:

Phase "engine_compare" runs gemma3-1b at full width in bf16, cut to one
local:global period (6 of its 26 layers: ``PERIOD_LAYERS``), behind the
dict-cache engine (one batch-1 decode and one host sync per slot, exact-
length prefill) and the stacked engine, at 1, 4 and 8 slots (max_seq 64,
prompts of 6 to 23 tokens, requests that never finish, 4 warm and 40
timed steps): step ms, tokens/s and the speedup. It checks n_layers x
slots x steps decode launches for the dict engine and n_layers x steps
for the stacked one, one wgmma flash launch a layer a prompt, and that
every token is in the vocab; it reports, unchecked, the share of positions
where the two engines' greedy streams agree (bf16 rounds a batch of rows
otherwise than one row).

Phase "serving_loop" is e11's loop: ``real_serving_scenario`` with
gemma3-1b at full width in bf16, cut to the same 6 layers (2 services on
6 chips, bursty load to 4 and 14 rps, 4 slots, max_seq 64, the SLO
accountant with the latency override on service 0), 180 simulated
seconds (e11 runs 600; 6 solved decides) of the fixed equal split and of
the RASK agent (xi 12, resource "chips").
Launch counters are zeroed just before each run and read just after:
decode n_layers x engine steps, flash (all wgmma) n_layers x admissions
(the engines' own ``steps`` and ``admissions``), the RASK forward once
and the backward 32 times a solved decide, no plain version on the card.
Then the RASK forward and backward kernels run on the loop agent's own
tables and fitted models (2 services, 6 SLOs, features chips, context and
rung), K = pgd_starts random candidates and the loop's last load, each
held against its plain version at 1e-5 and timed, and a
``profile_window`` covers 3 decode steps at the lowest and highest rung
that ran. Last, with nothing on the card timed beside them, two child
processes that never touch the card run each loop's CPU twin: the port
at ``repro``'s setting (smoke cut, float32), the RASK twin's agent taking
the card agent's random starts, seed by seed. The schedule reads no model
output and no clock, so the fixed run's cycle records, ledgers and drops
must equal the CPU's, the RASK run's exploration plans must equal the
CPU's and its solved plans agree within 2e-3 of each coordinate's range,
its post-exploration mean
fulfillment lie within 0.03 of the CPU's, and no plan or applied
assignment may exceed 6 chips. It reports the decide ms inside the loop
(each, and the median after the first), the alerts a cycle, each run's
wall seconds, the peak memory, the median measured decode-step ms at
each rung that ran, and whether the context and rung steps applied each
cycle equal the CPU twin's.

The multi-host fleet (src/repro_torch/core/fleet.py, the fleet solve
and placement of core/solver.py and core/rask.py) adds:

Phase "fleet_solve" solves e6's 2-bucket hetero fleet (16 hosts of 2
services on 4 cores, 8 of 8 on 16; 96 services) and e6's scale point
(100 hosts x 10 services on 20 cores) with ``FleetSolverProblem.
solve_many`` on the card: one forward and 32 backward launches a layout
bucket (counters zeroed just before, read just after), scores within
1e-4 relative of the card's per-row loop (``solve_sequential``) and 1e-3
of the CPU twin fed the same uniforms (``FLEET_REL``: at most one row in
1,000 past it, the median at float32 rounding), every host inside its
budget, no plain version on the card. It scores e8's capped placement batch at the
scale point (1,100 candidate rows, 6 starts x 32 steps as e8 scores
them) the same way against the CPU, and records wall ms (the agent's
4 x 16 budget too) and a ``profile_window`` of each: device busy ms,
idle share and launch calls a solve.

Phase "failover" runs e8's failover stage on the card: the tiered
camera/hub/gateway fleet (9 services), 1200 simulated seconds,
``RaskConfig(xi=20, eta=0.0, rebalance_every=3)``, hub-0 drained at 720 s.
It checks 2 hosts and 9 services after the drain, no capacity clip in any
receipt, windowed telemetry answering for all 9, and the RASK kernels'
launches: one forward and 32 backward a layout bucket a solved decide,
one forward and 16 backward a bucket a placement snapshot (the agent
notes each decide's and snapshot's bucket count). It reports e8's three
figures (pre-outage mean, post-outage dip, recovered mean), the decide ms
(median after the first), a snapshot's ms, the moves, and a
``profile_window`` of 3 decides and of 3 snapshots. Then the CPU twin
runs the same world, its random starts drawn from generators on the card
seeded as the card agent's are: its exploration plans must equal the
card's and its post-exploration mean fulfillment lie within 0.03.

Phase "fleet_kernels" holds the batched forward and backward (B problem
rows a launch) against their batched plain versions at ``RASK_TOL`` of
scale on the fleet path's shapes: the hetero fleet's two buckets (16 x 6
and 8 x 6 CTAs), the 100-host bucket (600), the placement batch at 6
starts (6,600) and at the agent's 4 (4,400), and the failover agent's own
bucket (its fitted models, padding included). Each case records device
and call ms, the plain version's ms, the per-row loop of the un-batched
launch (CUDA events around B launches queued as a caller queues them),
the bound and the kernels a call (1, checked).

The beyond-paper decide options (``RaskConfig(pipeline, forecast,
adapt_budget, transfer_priors)``, the arrive/depart churn) add, each with
the RASK launch counters zeroed just before its runs and read just after,
checked against the solves' and snapshots' buckets at the budget each ran
with, and no plain version on the card:

Phase "pipeline" runs e6's ``pipeline_bench`` world: 48 services (16 x
the paper triple) on 16 hosts of 8 cores, ``RaskConfig(xi=14,
eta=0.0)``, 400 s, synchronous and then pipelined. It reports each mode's
median ``runtime_s``, ``dispatch_s`` and ``collect_s``, the mean
post-exploration fulfilment, the hidden fraction (1 - pipelined /
synchronous median runtime, from 10 rounds of the two agents' decides
taken in turns after the runs, beside the two runs' own medians;
recorded against ``repro``'s 0.5 bar, not held) and a ``profile_window``
of 3 decides. It checks the one-cycle lag
(each emitted plan is the pinned copy of the previous round's dispatch),
the fill round at round xi, at least one collect that found its event
complete, at most one device-to-host copy and no synchronising call in a
pipelined decide, and that a forced migration and an arrival each drop the
pending result (the next cycle is a fill round).

Phase "forecast" runs e10's ``proactive_bench``: e3's bursty and diurnal
traces on the paper triple, ``RaskConfig(xi=12, eta=0.0)``, 1200 s,
reactive and then ``forecast=True``. Per trace: mean post-exploration
fulfilment, the violation rate at 0.9, proactive cycles, the worst rolling
error, the design-window uploads over the last 8 cycles (must be 0), and
the launch calls and device busy ms a forecast decide adds over a
reactive one (``profile_window``); at most one device-to-host copy a
decide. A CPU twin of the forecast run, fed the card's uniforms, must
agree on ``forecast_used`` cycle by cycle and on the fulfilment within
0.03.

Phase "transfer" runs e10's ``transfer_bench``: the diurnal trace, a QR
arrival at 400 s of 600, forecast on, with and without transfer priors:
no post-arrival exploration cycle with priors, at least one without.

Phase "burn_budget" runs e9's ``burn_failover_bench``: the failover world
(1200 s, hub-0 drained at 720 s), ``RaskConfig(xi=20, eta=0.0,
rebalance_every=3, adapt_budget=True)`` and ``SLOAccountant(
sim_slo_budget())``. It reports the fast alert's fire and clear times,
the pre-outage, dip and recovered fulfilment, and the solve and scorer
budget of every cycle; the budget must move, a fast alert must fire, and
every cycle under a firing alert must solve at the full budget. Then
the forward and backward kernels run on that agent's tables and models at
K = 2 and 3 and, batched, its fleet bucket and its placement batch at
K = 2, each held against its plain version at ``RASK_TOL`` and timed,
and ``profile_window`` times 3 decides at the full budget and 3 at the
floor.

The paper's comparison (the SLSQP reference and the seed's loop objective
of core/solver.py, ``RaskConfig(backend="slsqp", fused=False,
auto_degree=True)``, core/agents, obs/registry.py and prometheus.py) adds,
each phase with the RASK launch counters zeroed just before its runs and
read just after:

Phase "backends" (e7's ``decide_slsqp``/``decide_loop`` and
``examples/compare_solvers.py``): the paper triple with 1 and 3 replicas
(|S| = 3, 9), trained 300 s as e3 trains (xi 20, PGD) and transplanted
into a fresh agent of each of ``pgd``, ``slsqp`` and ``slsqp`` with
``fused=False``, 120 s at the default loads. Per configuration: median
and p90 decide ms, RASK launches a decide, SLSQP evaluations a solve,
the synchronising calls in one decide (``set_sync_debug_mode``: fused
SLSQP at most one a scipy evaluation, and one forward launch each) and a
``profile_window`` of 2 decides (launch calls, busy, idle). Gates: on the
trained agent's warm-started problem PGD scores at least SLSQP's - 5%
(``tests/test_solver.py``'s parity bar), and ``solve_slsqp`` on the card
scores within 1e-4 relative of its CPU twin's from the same models and
x0.

Phase "auto_degree": ``auto_degree=True`` on the paper triple under e3's
diurnal mix, 600 s, beside the fixed degree: the degrees each selection
picked, decide ms on selection cycles and the others, fulfilment against
the fixed degree. Gate: ``select_degree`` on the card, on the agent's own
last selection of each service, picks the CPU's degree (unless the best
two errors lie within 1%), and its errors agree within 1e-4 relative.

Phase "rask_kernels_k1": both RASK kernels at one candidate (K = 1, B =
1) on the |S| = 3 and 9 agents of "decide_timing", and at the
auto-degree tables (the |S| = 9 agent refitted at mixed degrees 1-6,
cv-analyzer at 6: T = 84; the "auto_degree" agent's own) at K = 1 and 6,
each against its plain version at ``RASK_TOL`` and timed like
"rask_kernels". At these degrees a prediction sums up to 84 terms of
large weights of both signs, so each bar adds 32 float32 ulp of the
sums' magnitude (``_sum_magnitudes``; without it the first full run's
forward parted by 4.9e-5 at T = 84, K = 1, over a bar of 2.8e-5, and a
probe's backward by 7.6e-5 at K = 6 over 4.6e-5).

Phase "sota" is e3 cut to one rep of 900 s a trace (e3: 1800 s x 2):
e3's bursty and diurnal traces (QR to 100 rps, CV to 10 rps with seed +
100, PC constant 50; 8 cores), RASK with SLSQP and with PGD (each a
transplant of one 300 s trained run), the VPA and the DQN (pretrained
once, 1500 steps a service, on the trained RASK's tp_max surfaces). Per
agent: mean, peak (load >= 0.4) and low fulfilment, violations at
0.8/0.9/0.95/1.0 over all and peak cycles, and e3's
``violation_reduction_vs_best_baseline`` (the paper's 28%, reported and
not gated); the DQN's pretrain wall seconds and the launch calls of one
TD step. Every run has a CPU twin in a child process that never touches
the card (beside the card's runs; the PGD twin takes the card's random
starts seed by seed). Gates: every run completes with fulfilment in [0,
1]; the VPA's card run equals its CPU twin cycle by cycle; RASK (PGD)'s
mean fulfilment lies within 0.03 of its twin's. RASK (SLSQP) is one local
search warm-started from the last optimum, so free-running a float32
rounding apart sends a solve to another local optimum and the warm start
keeps the run there (the first probe of this phase: identical inputs at
round 36, the card's solve 4.119 and the CPU's 4.367, then 0.717 against
0.852 mean fulfilment); its free-running twin is reported, and a second
twin in lockstep (the card's plans emitted, the card's optima as warm
starts) solves from the card's inputs: median score gap <= 1e-4, 90% of
the solves within 1e-3.

Phase "metrics": ``golden_signals`` over the "sota" SLSQP agent (diurnal)
with an ``SLOAccountant`` attached for 60 more seconds, ``snapshot``, and
one GET of ``MetricsServer`` on port 0 over loopback: the text carries
``repro_slo_budget_consumed``, ``repro_service_fulfillment`` and the
solver internals (``repro_decide_*``), and the GET equals ``render``.

The control plane's CLI over its three LM services and the MoE decoder
(models/moe.py, launch/autoscale.py, launch/fleet_autoscale.py,
launch/hetero_fleet.py) add, after the phases above have freed their
models:

Phase 1 also holds the attention kernels at qwen2-moe-a2.7b's shapes:
decode at 4 rows of a 2048-slot cache, 16 query heads on 16 kv heads
(G = 1), d_head 128 ("moe"), and flash at 16 on 16 heads, d_head 128, the
128, 512 and 1024 buckets, no window ("moe_S*"), each against its plain
version and SDPA, with its bound.

Phase "moe_crosscheck" runs qwen2-moe-a2.7b at full width (d_model 2048,
60 experts of d_ff 1408 top-4 and 4 shared, vocab 151936), cut to 2
layers, in float32: a 300-token prompt right-padded to the 512 bucket
(one routing group, capacity 42) and 4 decode steps on the card against
the same weights on the CPU (logits within 1e-3, phase 2's bar). Every
MoE call's expert choices and kept routes (``recording_routes``) must be
the CPU's, bit for bit; the prefill must launch the float32 flash kernel
once a layer, each decode step the decode kernel once a layer.

Phase "moe_serve" is phase 3 on qwen2-moe-a2.7b at full width in bf16
(24 layers, ~14.3 B parameters, 28.6 GB; weights from the card's seeded
generator): the same engine, requests and launch checks, the memory
resident before (the earlier models freed) and the phase's own peak, and
the routes dropped at capacity in each bucket (the dense GShard dispatch
routes pads with the real tokens: they take capacity at choices >= 1).
Phase "moe_trace" is ``phase_trace`` on that engine, beside a decode
step's byte bound: every layer's weights (all experts enter the dense
dispatch), the head and the KV slots read, over 3.35 TB/s.

Phase "autoscale_cli" runs ``launch.autoscale.main`` on the card and with
``--device cpu``: the default (10 simulated minutes, diurnal), then
``--hosts 3 --replicas 3 --rebalance-every 3 --slo-burn --dump-metrics``.
It prints both runs' summary lines; the exploration plans must be the
CPU's exactly, the dumps must hold the same metric families, every
fulfilment lie in [0, 1], and the card's decides must have launched the
RASK kernels (at least one forward and 32 backward a solved decide).
Phase "fleet_launchers" runs ``launch.fleet_autoscale`` and
``launch.hetero_fleet`` on the card: both end with every host inside its
budget, a fulfilment line and RASK launches.

The last two model families (models/transformer.py's encoder-decoder,
mixed cache and hybrid programs) add, after the phases above have freed
their models:

Phase 1 also holds the kernels at the new shapes: decode for whisper's
decoder (20 heads on 20 kv heads, d_head 64: self-attention at 68 of 448
slots, cross-attention over 1,500 frames), gemma3-1b's full 512-slot
ring and jamba's attention (64 heads on 8 kv heads, d_head 128); flash
for whisper's encoder (1,500 frames, not causal), the prompt's
cross-attention (4 queries over 1,500 frames, not causal) and its causal
4-token self-attention, and jamba's 300- and 1000-token prompts; phase
"ssd_kernels" the scan at jamba's 256 heads of 64 (l = 384, 1024).

Phase "encdec_crosscheck" runs whisper-large-v3 at full width cut to 2
encoder and 2 decoder layers, float32: one clip of 1,500 frames, a
4-token prompt and 4 decode steps on the card against the CPU (logits
and cross K/V within 1e-3, argmax equal), with the float32 flash and
decode launches a layer. Phase "encdec_serve" is whisper-large-v3 at
full width in bf16 (1.54 B parameters) through ``Model.prefill`` and
``Model.decode`` (the engine takes no frames): 4 clips of 1,500 seeded
frames, a 4-token prompt, 64 greedy decode steps; launch counts checked
(flash once an encoder layer and twice a decoder layer, decode twice a
decoder layer a step), no plain version on the card; encode ms, prefill
ms, decode-step ms, decode tokens/s and peak memory. Phase
"encdec_trace" profiles 3 decode steps and one prefill beside a step's
byte bound.

Phase "mixed_cache" runs gemma3-1b at full width in float32, cut to the
same 6 layers (5 local, 1 global), with ``mixed_cache=True``: 2 rows
decode 528 steps (the 512-slot rings wrap) from token 0, in lockstep with
the full-cache decode fed the same seeded tokens; the largest logit gap
(bar 1e-3), both paths' step ms, the two caches' bytes and the decode
launches (one a layer a step on each path).

Phase "hybrid_crosscheck" runs jamba's one period at a narrower width
that keeps its attention and SSD shapes (d_model 1024, 64 heads on 8 kv
heads, d_head 128, SSD state 128, heads of 64, chunk 128, 4 experts),
float32: a 300-token prompt and 4 decode steps on the card against the
CPU (logits within 1e-3, the kept routes bit for bit). Phase
"hybrid_serve" serves jamba-1.5-large-398b at full width in bf16, cut to
one period (8 sublayers) and 8 of its 16 experts (25.8 B parameters,
51.6 GB), behind phase "serve"'s engine and requests at their exact
lengths: launch counts (decode once an attention sublayer a step, flash
once a prompt, the SSD scan once a Mamba-2 sublayer a prompt), no plain
version on the card, prefill ms by length, the routes dropped at
capacity, peak memory. Phase "hybrid_trace" is ``phase_trace`` on that
engine beside a decode step's byte bound (every weight but the
embedding table, the K/V read, the Mamba-2 states read and written).

Training. Phase "train_kernels" holds attention's backward kernel
(``csrc/flash_attention_backward.cu``: three or four CUDA kernels a call,
as ``flash_attention.plan_of`` says, checked with the profiler; two calls
bitwise equal) and the forward kernels' ``lse`` against their plain
versions, in float32 (1e-4 of each gradient's largest entry; lse within
1e-4) and bf16 (5e-2; lse 1e-3), at gemma3-1b's training shape (4 x 1,024
tokens, 4 query heads on 1 kv head, d_head 256, causal, window 512 and
none), a ragged 600-token row and whisper's decoder over its frames (187
tokens against 1,500, G = 1, d_head 64, not causal). It times the backward
(device and call ms, and each of its CUDA kernels with the profiler), its
plain version and, as the library yardstick, SDPA's backward alone on a
retained graph (which the port never calls), beside its bound: bytes over
3.35 TB/s against five products' flops over 67 or 989 TFLOP/s, and in
float32 also over the tensor cores' TF32 rate (3 x flops over 494.7
TFLOP/s); its CTAs a pass from the plan; and the forward with and without
``lse`` beside the forward's plain version and SDPA's forward. Phase
"train_crosscheck" runs gemma3-1b at full width cut to 2 layers (one
local, one global), float32, on one 600-token row: the loss and every
gradient leaf on the card against the CPU (1e-4; 1e-3 of each leaf's
largest entry), the flash forward and backward kernels once a layer, then
one AdamW update on each side from the same gradients (1e-6). Phase
"train" trains gemma3-1b at full width cut to one local:global period (6
layers: ``PERIOD_LAYERS``), float32 (0.46 B parameters), through
``make_train_step(cfg, make_debug_mesh(), ...).fn`` (the ``StepBundle``
on the 1 x 1 mesh over the card) and the ``Trainer`` on
``TokenPipeline(vocab=262144, batch=4, seq=1024)`` for 12 steps, the
checkpoint in a temporary directory: losses and grad norms finite, the
loss falling, the forward and backward kernels 6 times a step, peak
memory under 80 GB; the final checkpoint restored by a resumed
``Trainer`` through ``restore(..., shardings=)`` of the bundle's
``in_shardings``, on the card and bitwise equal, at the saved step. It
reports step ms, tokens/s against the step's bound (6 N tokens over 67
TFLOP/s), peak memory, the checkpoint's save and restore seconds
and bytes, and a ``profile_window`` over 2 steps with the backward
kernel's share of device time, and the final weights' loss on the first
and last batches it trained on. Its optimizer is ``launch/train.py``'s
at ``--lr 1e-3``: at the launcher's default 3e-3, set for the smoke cut,
the full width's loss rose.

Training the SSD scan. Phase "ssd_backward_kernels" holds the scan's
backward kernel (``csrc/ssd_scan_backward.cu``: four CUDA kernels a call,
checked with the profiler, split between CTAs and clusters as
``ssd_scan.backward_plan`` says on this card; two calls bitwise equal)
against its plain version (``ref.ssd_backward_reference``), in float32
(1e-4 of each gradient's largest entry) and bf16 (5e-2), on mamba2-370m's
training shape (4 x 1,024 tokens, 32 heads of 64, state 128, chunk 128),
jamba's full-width Mamba-2 sublayer (256 heads) at l = 384 and 1,024, two
rows with an initial state and a final-state cotangent, and one chunk. It
times the backward, its plain version and the forward kernel at the same
shapes, beside the bound (the function's own bytes over 3.35 TB/s against
its flops over 67 or 989 TFLOP/s; in float32 also 3 x flops over TF32's
494.7, as the kernel runs them), and, at mamba2's shape, other partitions
of the heads; no PyTorch call computes this function. Phase
"ssm_train_crosscheck" holds the loss and every gradient leaf on the
card against the CPU (the loss and each leaf within 1e-4 of its largest
entry, the per-head leaves A_log, dt_bias and D within 3e-4) for
mamba2-370m at full width cut to 2 layers on a ragged 600-token row (and
both against a float64 CPU run) and for jamba's period at
"hybrid_crosscheck"'s narrow cut, with the launch counts. Phase
"ssm_train" trains mamba2-370m, all 48 layers at full width, float32
(419.8 M parameters), as phase "train" trains gemma3-1b but without the
checkpoint: losses finite and falling, the SSD forward and backward
kernels 48 times a step, no plain version on the card, peak memory under
80 GB; it reports step ms, tokens/s against 6 N tokens over 67 TFLOP/s
and a ``profile_window`` over 2 steps with the SSD kernels' shares of
device time.

The dry run. Phase "dryrun" reads the two trained states and median
steps of "train" and "ssm_train" and builds no model: for each, the
``StepBundle``'s abstract arguments (meta tensors) equal the trained
parameters and optimizer state leaf for leaf in shape and dtype, their
per-device bytes under the bundle's shardings on the 1 x 1 mesh equal
the state's bytes on the card exactly, and ``launch/dryrun.py::run_cell``
counts the step on meta, the kernels by their own work and the other ops
as eager PyTorch runs them: its bound, max(counted flops over 67 TFLOP/s,
the kernels' over 494.7/3 (float32 as three TF32 products), counted bytes
over 3.35 TB/s), must be at most the measured median step (a bound above
a measured step is a wrong count). It prints both times and their ratio.

Several devices (ROADMAP item 31). Phase "fleet_shards" runs
``core/solver.py::shard_rows``: e6's two fleets solved and e8's 1,100
placement candidates scored with each layout bucket's rows cut into 1, 2
and 4 chunks, all on the one card: assignments and scores byte-identical
to one chunk, the RASK kernels' launches the non-empty chunks x 33, no
plain version on the card, the scores held to the CPU twin's as in
"fleet_solve"; it reports each count's median ms (with several cards,
one more count: a chunk on each card). Phase "mesh" runs the
step bundles on a one-rank ``nccl`` world's (1, 1) mesh, every tensor a
DTensor placed by the bundle's shardings: gemma3-1b at full width cut to
``PERIOD_LAYERS``, a bf16 prefill of 4 x 1,024 tokens and 8 decode steps
(tokens equal to the one-device steps', logits and cache within 5e-2), a
float32 train step twice on 4 x 1,024 tokens (loss, grad norm and Adam's
moments within 1e-4 relative); the same for mamba2-370m (8 of 48
layers; 4 x 1,000 prompt tokens; its train step through the SSD scan's
forward and backward kernels under ``local_map``), and serving for
qwen2-moe-a2.7b (2 of 24 layers, the 512 bucket, its kept routes equal)
and jamba's period (``_jamba_cut``, 4 x 1,000); whisper-large-v3 at full
width and depth (4 clips of 1,500 frames, an 8-token prompt, the bundles
built with seq = 1,500 frames) and its float32 train step cut to 8 + 8
layers; gemma3-1b's mixed ring cache, decoded on one device to W - 8,
then 16 steps on both across the ring's wrap (``_mesh_mixed``). For
each: the kernels' launch counts zeroed before and read after the mesh
run, the placed state's local bytes equal to the dry run's per-device
bytes, and each step's ms beside the one-device step's; gemma3-1b's bf16
weights also restored onto the mesh bit for bit. "ssd_kernels" and
"ssd_backward_kernels" also hold the scans at a rank's local shapes on
meshes of several cards (``MESH_SSD_SHAPES``), and "kernels" the decode
kernel over whisper's frames and the flash kernel over its encoder
(``MESH_WHISPER_SHAPES``).
Whether two ``gloo`` ranks on the one card carry the steps is a probe run
by hand (``python -m repro_torch.launch.gloo_on_cuda``), not a phase.

Every phase line carries its wall ``seconds``.

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
import math
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
    plus edge rows (length 1, a full cache, an idle lane past the cache);
    e11's loop: a 64-slot cache of 4 rows and of 1 row; qwen2-moe's
    decode ("moe"): 16 query heads on 16 kv heads (G = 1), d_head 128,
    the same rows of a 2048-slot cache, no window; whisper-large-v3's
    decoder, 20 heads on 20 kv heads, d_head 64, 4 clips: self-attention
    at its last step (68 of 448 slots) and cross-attention over all 1,500
    encoder frames; gemma3-1b's mixed cache, 2 rows of a full 512-slot
    local ring; jamba's attention layer, 64 heads on 8 kv heads
    (G = 8), d_head 128, the serving rows of a 2048-slot cache; and
    whisper's cross cache at a rank's local (rows, heads) on the (2, 2),
    (1, 4) and (4, 1) meshes (``MESH_WHISPER_SHAPES``)."""
    H, KH, D, S = 4, 1, 256, 2048
    lengths = [108, 308, 708, 1008]
    cases = {
        "global": (lengths, [0] * 4, S, H, KH, D),
        "local": (lengths, [max(0, n - 512) for n in lengths], S, H, KH, D),
        "edges": ([1, 2048, 2060, 513], [0, 1536, 1548, 1], S, H, KH, D),
        # e11's loop: a 64-slot cache, 4 rows (stacked engine) or 1 (dict)
        "e11_stacked": ([20, 33, 47, 64], [0] * 4, 64, H, KH, D),
        "e11_dict": ([33], [0], 64, H, KH, D),
        "moe": (lengths, [0] * 4, S, 16, 16, 128),
        "whisper_self": ([68] * 4, [0] * 4, 448, 20, 20, 64),
        "whisper_cross": ([1500] * 4, [0] * 4, 1500, 20, 20, 64),
        "mixed_ring": ([512] * 2, [0] * 2, 512, H, KH, D),
        "jamba": (lengths, [0] * 4, S, 64, 8, 128),
        **{f"whisper_cross_r{b}h{h}": ([1500] * b, [0] * b, 1500, h, h, 64)
           for b, h in MESH_WHISPER_SHAPES},
    }
    g = torch.Generator(dev).manual_seed(11)
    out = []
    for name, (lens, starts, S, H, KH, D) in cases.items():
        B = len(lens)
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
    a CTA) and two rows of a 17-token prompt (S < 64); e11's
    prompts (13 and 32 tokens); qwen2-moe's buckets 128, 512 and 1024
    ("moe_S*"): 16 query heads on 16 kv heads (G = 1), d_head 128, no
    window; whisper-large-v3's 4 clips, 20 heads on 20 kv heads, d_head
    64: the encoder (1,500 frames, not causal), the prompt's
    cross-attention (4 queries over 1,500 frames, not causal) and its
    self-attention (4 tokens, causal); jamba's exact-length prompts of
    300 and 1000 tokens, 64 heads on 8 kv heads (G = 8), d_head 128; and
    whisper's encoder at a rank's local (rows, heads) on the (2, 2) and
    (1, 4) meshes. Each case is (name, q, k, v, window, causal)."""
    g = torch.Generator(dev).manual_seed(12)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    out = []
    for S in (128, 512, 1024):
        for window in (512, 0):
            out.append((f"S{S}_w{window}", randn(1, 4, S, 256),
                        randn(1, 1, S, 256), randn(1, 1, S, 256), window,
                        True))
    out.append(("G8_S200_w0", randn(1, 8, 200, 64), randn(1, 1, 200, 64),
                randn(1, 1, 200, 64), 0, True))
    out.append(("B2_S17_w8", randn(2, 2, 17, 64), randn(2, 1, 17, 64),
                randn(2, 1, 17, 64), 8, True))
    # e11's loop: a 13-token prompt at its exact length (dict engine) and
    # the 32-token bucket (stacked engine); window 512 exceeds max_seq 64
    for S in (13, 32):
        out.append((f"e11_S{S}", randn(1, 4, S, 256), randn(1, 1, S, 256),
                    randn(1, 1, S, 256), 512, True))
    for S in (128, 512, 1024):
        out.append((f"moe_S{S}", randn(1, 16, S, 128), randn(1, 16, S, 128),
                    randn(1, 16, S, 128), 0, True))
    for name, S, T, causal in (("whisper_enc", 1500, 1500, False),
                               ("whisper_xattn", 4, 1500, False),
                               ("whisper_prompt", 4, 4, True)):
        out.append((name, randn(4, 20, S, 64), randn(4, 20, T, 64),
                    randn(4, 20, T, 64), 0, causal))
    for S in (300, 1000):
        out.append((f"jamba_S{S}", randn(1, 64, S, 128), randn(1, 8, S, 128),
                    randn(1, 8, S, 128), 0, True))
    for b, h in MESH_WHISPER_SHAPES[:2]:
        out.append((f"whisper_enc_r{b}h{h}", randn(b, h, 1500, 64),
                    randn(b, h, 1500, 64), randn(b, h, 1500, 64), 0, False))
    return out


def phase_kernels(dev):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     forward_work, kv_splits)

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
            # the grid the timed calls launched, as the wrapper records it
            row["ctas"] = decode_attention_cuda.last_ctas
            row["kernels_per_call"], row["kernel_names"] = \
                kernels_per_call(lambda: decode_attention_cuda(
                    q, k, v, length, start))
            check(row["kernels_per_call"] == 1,
                  f"decode {name} {dname}: {row['kernels_per_call']} "
                  f"kernels a call ({row['kernel_names']}), want 1")
            row["plain_ms"], row["plain_call_ms"] = time_ms([
                (lambda c=c: ref.decode_attention_reference(
                    c[0], c[1], c[2], length, start)) for c in copies], 20)

            # SDPA's inputs: kv heads repeated to the query heads (G = H/KH),
            # made before the clock starts
            lib_in = [(c[0][:, :, None],
                       c[1].transpose(1, 2).repeat_interleave(H // KH, 1),
                       c[2].transpose(1, 2).repeat_interleave(H // KH, 1))
                      for c in copies]

            def sdpa(c):
                return F.scaled_dot_product_attention(
                    *c, attn_mask=mask)[:, :, 0]
            lib = sdpa(lib_in[0])
            torch.cuda.synchronize()
            row["library_err"] = (lib.float() - want.float())[live].abs() \
                .max().item()
            row["library_ms"], row["library_call_ms"] = time_ms(
                [(lambda c=c: sdpa(c)) for c in lib_in], 20)
            del copies, lib_in
            rows.append(row)
            log(f"decode {name} {dname}: {row}")

        for name, q, k, v, window, causal in flash_cases(dev, dtype):
            got = flash_attention_cuda(q, k, v, causal=causal, window=window)
            want = ref.flash_attention_reference(q, k, v, causal=causal,
                                                 window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(err <= TOL[dname], f"flash {name} {dname}: error {err}")
            B, H, S, D = q.shape
            T = k.shape[2]
            qpos = torch.arange(S, device=dev)[:, None] + (T - S)
            kpos = torch.arange(T, device=dev)[None, :]
            open_ = qpos >= kpos if causal else \
                torch.ones((S, T), dtype=torch.bool, device=dev)
            if window:
                open_ &= qpos - kpos < window
            nbytes, flops = forward_work(q, k, causal=causal, window=window)
            row = {"kernel": "flash_attention", "case": name, "dtype": dname,
                   "variant": "wgmma" if dtype == torch.bfloat16
                   else "tf32x3", "causal": causal, "max_abs_err": err,
                   "bound": bound_ms(nbytes, flops, dname)}

            def call():
                return flash_attention_cuda(q, k, v, causal=causal,
                                            window=window)
            row["ms"], row["call_ms"] = time_ms([call], 20)
            if dtype == torch.float32:
                # the tensor cores' time for the products the kernel issues
                t_bytes = nbytes / HBM_BYTES_PER_S
                t_ops = 3 * flops / TF32_FLOPS
                row["bound_tf32x3"] = [1e3 * max(t_bytes, t_ops),
                                       "bytes" if t_bytes >= t_ops
                                       else "operations"]
                row["kv_splits"] = kv_splits(q, k, causal=causal,
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
                    q, k, v, causal=causal, window=window)], 10)
            KH = k.shape[1]
            if KH in (1, H):
                kk, vv = k.expand(B, H, T, D), v.expand(B, H, T, D)
            else:                 # G = H/KH heads a kv head, repeated
                kk = k.repeat_interleave(H // KH, 1)
                vv = v.repeat_interleave(H // KH, 1)
            if window or (causal and S != T):
                def sdpa():
                    return F.scaled_dot_product_attention(q, kk, vv,
                                                          attn_mask=open_)
            else:
                def sdpa():
                    return F.scaled_dot_product_attention(q, kk, vv,
                                                          is_causal=causal)
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


def phase_serve(dev, arch="gemma3-1b", name="serve", wrap=FiniteLogits):
    """``arch`` at full width in bf16 behind the ServingEngine: the 8
    requests, launch counts checked, prefill ms by bucket (phases "serve"
    and "moe_serve")."""
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     reset_launches)
    from repro_torch.models import build
    from repro_torch.serve.engine import (EngineConfig, Request,
                                          ServingEngine, bucket_length)

    cfg = get(arch)                            # full width, bf16
    model = wrap(build(cfg))
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
    res = {"phase": name, "model": cfg.name, "params": n_params,
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



PROFILE_TRIES = 6
WAKE_KERNEL = "spin_kernel"   # the name of ``torch.cuda._sleep``'s kernel


def not_measured(num, den):
    """``num / den``, or None where the tracer measured neither."""
    return None if num is None or den is None else num / max(den, 1e-9)


def dev_us(e):              # the attribute's name moved in torch 2.4
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def traced(label, fn, n):
    """``torch.profiler`` over ``n`` calls of ``fn`` (after one warm call):
    (the key averages, the trace's launch calls that ``fn`` made, wall us a
    call, tries that recorded no device event).

    A short trace of only the port's own kernels (a few calls of a
    sub-millisecond backward) often recorded no device event at all, though
    it recorded their launch calls, and more often the longer the host had
    waited since the trace before it; traces that also ran PyTorch's
    kernels never dropped them. So each trace first launches one empty
    PyTorch kernel (``torch.cuda._sleep(1)``; its event and its launch call
    are left out of what this returns), and a trace with no device event
    is taken again at once, up to ``PROFILE_TRIES`` times in all, each
    dropped try logged. ``PROFILE_TRIES`` dropped tries mean the device
    was not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for dropped in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0) / n
        ka = [e for e in prof.key_averages() if WAKE_KERNEL not in e.key]
        launches = sum(e.count for e in ka if e.device_type == DeviceType.CPU
                       and e.key in _LAUNCH_KEYS) - 1
        if sum(dev_us(e) for e in ka if e.device_type != DeviceType.CPU) > 0:
            return ka, launches, wall_us, dropped
        log(f"traced {label}: the tracer recorded no device event "
            f"(try {dropped + 1} of {PROFILE_TRIES})")
    return ka, launches, wall_us, PROFILE_TRIES


def profile_window(label, fn, n, share_of=()):
    """``traced`` over ``n`` calls of ``fn``.

    Device busy time is the summed duration of the device's own events
    (kernels, copies, memsets). A CPU op's device time repeats the kernels
    it launched, so CPU ops are left out of that sum; the rest of the wall
    clock the device idles. Also counts the kernel launch calls a call and
    the device-to-host copies the device ran a call, and, for each name in
    ``share_of``, the device ms a call of the kernels whose names hold it.
    ``dropped_windows`` counts the traces that recorded no device event; if
    every try dropped them, the device numbers are None (not measured),
    never zeros."""
    from torch.autograd import DeviceType
    ka, launches, wall_us, dropped = traced(label, fn, n)
    dev = [e for e in ka if e.device_type != DeviceType.CPU]
    host = [e for e in ka if e.device_type == DeviceType.CPU]
    res = {"window": label, "wall_ms": wall_us / 1e3,
           "dropped_windows": dropped,
           "launches": launches / n,
           "top_host_self_ms": [[e.key, e.self_cpu_time_total / n / 1e3,
                                 e.count / n] for e in sorted(
               host, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]]}
    if dropped == PROFILE_TRIES:
        res.update({"device_busy_ms": None, "device_idle_share": None,
                    "dtoh_copies": None, "top_device_ms": None})
        if share_of:
            res["device_ms_of"] = {name: None for name in share_of}
        return res
    busy = sum(dev_us(e) for e in dev) / n
    res.update({
        "device_busy_ms": busy / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy / wall_us),
        "dtoh_copies": sum(e.count for e in dev
                           if e.key.startswith("Memcpy DtoH")) / n,
        "top_device_ms": [[e.key, dev_us(e) / n / 1e3, e.count / n]
                          for e in sorted(dev, key=dev_us, reverse=True)[:8]]})
    if share_of:
        res["device_ms_of"] = {name: sum(dev_us(e) for e in dev
                                         if name in e.key) / n / 1e3
                               for name in share_of}
    return res


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


def _objective_args(agent, t, K, seed):
    """The objective's inputs as the solver gives them: the agent's tables
    and fitted models, K projected random candidates, the load of the 5 s
    before ``t``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    dev = agent.device
    p, sm = agent.problem, agent.stacked
    A = np.stack([p.random_assignment(rng, agent.capacity)
                  for _ in range(K)])
    rps = agent._rps_vector(agent.platform.window_states(t - 5, t))
    t = p.tables
    args = (torch.from_numpy(A).to(dev), t.rel_gather, sm.w, sm.exponents,
            sm.term_mask, sm.x_scale, t.slo_kind, t.slo_service,
            t.slo_weight, t.slo_target, t.slo_pidx, t.slo_ridx,
            torch.from_numpy(rps).to(dev))
    return args, dict(n_services=len(p.specs), max_degree=sm.max_degree)


def _objective_work(args, n_services, backward):
    """(bytes, flops) one call needs on these inputs: every input read once
    and the output written once; the flops of the real terms only (padded
    terms have mask 0) — features, powers, term products, phi, sums. A
    batched call (A (B, K, D)) sums its rows."""
    A, rel, w, E, tm = args[:5]
    B = A.shape[0] if A.dim() == 3 else 1      # problem rows
    K, D = A.shape[-2:]
    R, T, F = E.shape[-3:]
    Q, S = args[6].shape[-1], n_services
    nbytes = 4 * sum(t.numel() for t in args) \
        + 4 * B * K * (D if backward else S)
    if backward:
        nbytes += 4 * B * K * S                          # the cotangent
    real = (tm > 0)                   # padded rows of a bucket: mask 0
    n_real = int(real.sum())
    powers = int((E * real[..., None]).sum())             # x^e products
    fwd = B * R * F + powers + n_real * (F + 2) + B * (5 * Q + Q)
    if not backward:
        return nbytes, K * fwd
    bwd = fwd + powers + n_real * (F * (F - 1) + 4 * F + 1) \
        + B * (6 * Q + 2 * R * F + Q + R * F)
    return nbytes, K * bwd


def _sum_magnitudes(args, ct, kw):
    """What the kernels' float32 sums carry: the plain forward and backward
    with |w| and |ct|, every SLO unclipped (targets scaled by 1e6, the
    results by 1e6 back), i.e. the sums of the terms' magnitudes (the
    features are >= 0, so every term of a sum of |w| terms is). A degree-6
    fit of few rows has large weights of both signs, so these exceed the
    results by orders of magnitude, and two float32 sum orders part by a
    few ulp of them, not of the results. Returns (forward, backward)
    maxima."""
    from repro_torch.kernels import ref
    big = list(args)
    big[2] = args[2].abs()
    big[9] = args[9] * 1e6
    fwd = ref.rask_objective_reference(*big, **kw) * 1e6
    bwd = ref.rask_objective_grad(big[0], ct.abs(), *big[1:], **kw) * 1e6
    return fwd.abs().max().item(), bwd.abs().max().item()


def _rask_cases(agent, t, K, seed, case, cancellation=False):
    """The forward and backward kernels on ``agent``'s tables and fitted
    models, K random candidates and the load before ``t``, each held
    against its plain version at ``RASK_TOL`` and timed; one row each.
    ``cancellation``: each bar also carries 32 float32 ulp of its sums'
    magnitude (``_sum_magnitudes``): two orders of an 84-term sum with
    cancellation part by that, whichever is right."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rask_objective import (
        rask_objective_backward_cuda, rask_objective_forward_cuda)

    dev = agent.device
    args, kw = _objective_args(agent, t, K, seed)
    S = kw["n_services"]
    A = args[0]
    g = torch.Generator(dev).manual_seed(seed)
    ct = torch.randn((K, S), generator=g, device=dev)
    fwd = rask_objective_forward_cuda(*args, n_services=S)
    bwd = rask_objective_backward_cuda(A, ct, *args[1:], n_services=S)
    want_f = ref.rask_objective_reference(*args, **kw)
    want_b = ref.rask_objective_grad(A, ct, *args[1:], **kw)
    torch.cuda.synchronize()
    magnitudes = _sum_magnitudes(args, ct, kw) if cancellation \
        else (0.0, 0.0)
    rows = []
    for name, got, want, backward in (
            ("rask_objective", fwd, want_f, False),
            ("rask_objective_grad", bwd, want_b, True)):
        err = (got - want).abs().max().item()
        magnitude = magnitudes[backward]
        bar = RASK_TOL * (1.0 + want.abs().max().item()) \
            + 32 * 2.0 ** -23 * magnitude
        check(bool(torch.isfinite(got).all()),
              f"{name} {case}: non-finite output")
        check(err <= bar, f"{name} {case}: error {err} > {bar}")
        nbytes, flops = _objective_work(args, S, backward)
        row = {"kernel": name, "case": case, "K": K,
               "services": S, "dim": A.shape[1],
               "features": args[3].shape[2],
               "relations": args[3].shape[0],
               "terms": args[3].shape[1], "slos": args[6].shape[0],
               "max_abs_err": err, "tolerance": bar,
               "sum_magnitude": magnitude,
               "bytes": nbytes, "flops": flops,
               "bound": bound_ms(nbytes, flops, "float32")}
        if backward:
            def call():
                return rask_objective_backward_cuda(
                    A, ct, *args[1:], n_services=S)
            row["plain_ms"], row["plain_call_ms"] = time_ms([
                lambda: ref.rask_objective_grad(A, ct, *args[1:], **kw)], 50)
        else:
            def call():
                return rask_objective_forward_cuda(*args, n_services=S)
            row["plain_ms"], row["plain_call_ms"] = time_ms([
                lambda: ref.rask_objective_reference(*args, **kw)], 50)
        row["ms"], row["call_ms"] = time_ms([call], 200)
        row["kernels_per_call"], row["kernel_names"] = kernels_per_call(call)
        check(row["kernels_per_call"] == 1,
              f"{name} {case}: {row['kernels_per_call']} kernels "
              f"a call ({row['kernel_names']}), want 1")
        row["library_ms"] = None     # no single PyTorch call
        rows.append(row)
        log(f"{name} {case}: {row}")
    return rows


def phase_rask_kernels(dev, agents):
    from repro_torch.kernels.rask_objective import empty_launch_cuda

    rows = []
    for S, (env, agent) in sorted(agents.items()):
        for K in (6, 7):
            rows += _rask_cases(agent, env.t, K, S + K, f"S{S}_K{K}")
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
    relations = [dict(n_features=len(f), degree=agent._default_degree(sid),
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
    cpu_env = _rask_env(replicas, _e3_mix())
    cpu_agent = _rask_agent(cpu_env, torch.device("cpu"),
                            cls=_cuda_starts(RASKAgent, dev))
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


# (b, l, initial state, h): a rank's local shapes of the mesh phase's
# 4 x 1,024-token scans on meshes of several cards: mamba2-370m's
# 32 heads on (2, 2) and (1, 4), 16 and 8 a rank; jamba's 256 on a "model"
# axis of 2 and 4, 128 and 64 a rank, one row
MESH_SSD_SHAPES = ((2, 1024, False, 16), (4, 1024, False, 8),
                   (1, 1024, False, 128), (1, 1024, False, 64))


def ssd_cases(dev, dtype):
    """The scan's inputs at the slice's shapes (32 heads of 64, state 128,
    chunk 128), with test_ssd_sweep's distributions: the prompt lengths of
    phase "ssm_serve" rounded up to the chunk, and b = 2 with a non-zero
    initial state (two and six chunks); then jamba's Mamba-2 sublayers,
    256 heads of 64 ("h256"), at its 300- and 1000-token prompts (l = 384
    and 1024); then the local shapes of ``MESH_SSD_SHAPES`` ("h16", "h8",
    "h128", "h64")."""
    g = torch.Generator(dev).manual_seed(13)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    out = []
    for b, l, with_state, h in ((1, 128, False, 32), (1, 384, False, 32),
                                (1, 1024, False, 32), (2, 256, True, 32),
                                (2, 768, True, 32), (1, 384, False, 256),
                                (1, 1024, False, 256), *MESH_SSD_SHAPES):
        p, n = 64, 128
        args = [randn(b, l, h, p) * 0.5,
                torch.nn.functional.softplus(randn(b, l, h)),
                -torch.exp(randn(h) * 0.3),
                randn(b, l, n) * 0.5, randn(b, l, n) * 0.5]
        init = randn(b, h, p, n) * 0.5 if with_state else None
        name = ("" if h == 32 else f"h{h}_") + f"b{b}_l{l}" \
            + ("_init" if with_state else "")
        out.append((name, [t.to(dtype) for t in args],
                    None if init is None else init.to(dtype)))
    return out


def _ssd_work(args, init, chunk):
    """(bytes, flops) of one scan on these inputs (``ssd_scan.
    forward_work``): every input read once and both outputs written once;
    the chunked algorithm's flops with C B^T formed once per (row, chunk)
    and only the lower triangles of C B^T and of its product with x dt."""
    from repro_torch.kernels.ssd_scan import forward_work
    x, dt, A, B, C = args
    b, l, h, p = x.shape
    return forward_work(b, l, h, p, B.shape[-1], min(chunk, l),
                        x.element_size(), initial_state=init is not None)


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
    state_passing, chunk_scan), from ``traced`` over ``calls`` calls."""
    from torch.autograd import DeviceType
    ka, _, _, _ = traced("ssd_launch_breakdown", fn, calls)
    out = {}
    for e in ka:
        if e.device_type == DeviceType.CPU:
            continue
        us = dev_us(e)
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
    NAMES = ("ssd_reference", "ssd_backward_reference",
             "flash_attention_reference", "decode_attention_reference",
             "rask_objective_reference", "rask_objective_grad")

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


# -- e11: the engine comparison and the closed serving loop -----------------------

E11_XI, E11_SECONDS, E11_CHIPS = 12, 180.0, 6.0
# the phases that run gemma3-1b at full width for many steps
# ("engine_compare", "serving_loop", "mixed_cache", "train") cut it to one
# local:global period (5 local layers, 1 global), so that the whole script
# keeps well inside its time limit on a slow host: each layer adds launches
# and time (the decode steps are host-bound), and no check of theirs reads
# the depth but through the launch counts
PERIOD_LAYERS = 6


def gemma_period(**changes):
    """gemma3-1b at full width, cut to ``PERIOD_LAYERS`` layers."""
    from repro_torch.configs import get
    return dataclasses.replace(get("gemma3-1b"), n_layers=PERIOD_LAYERS,
                               **changes)


def phase_engine_compare(dev):
    """e11's engine stage at full width in bf16 (one local:global period
    deep): the dict-cache engine (one batch-1 decode and one host sync per
    slot) against the stacked one (one batched decode, one sync), every
    slot held by a request that never finishes, 4 warm then 40 timed steps
    at 1, 4 and 8 slots."""
    import numpy as np

    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     reset_launches)
    from repro_torch.models import build
    from repro_torch.serve import (DictCacheEngine, EngineConfig, Request,
                                   ServingEngine)

    cfg = gemma_period()                       # full width, bf16
    model = FiniteLogits(build(cfg))
    params = model.model.init(torch.Generator(dev).manual_seed(0))
    warm, timed = 4, 40
    res = {"phase": "engine_compare", "model": cfg.name, "dtype": cfg.dtype,
           "max_seq": 64, "warm_steps": warm, "timed_steps": timed}
    for slots in (1, 4, 8):
        row, streams = {}, {}
        for name, cls in (("dict", DictCacheEngine),
                          ("stacked", ServingEngine)):
            eng = cls(model, params, EngineConfig(
                slots=slots, max_seq=64, context=64, chips=8.0), device=dev)
            rng = np.random.default_rng(7)
            for i in range(slots):
                plen = int(rng.integers(6, 24))
                eng.submit(Request(i, rng.integers(0, cfg.vocab, plen)
                                   .astype(np.int32), max_new_tokens=10_000))
            torch.cuda.synchronize()
            decode_attention_cuda.launches = 0
            reset_launches()
            for _ in range(warm):
                eng.step()
            check(len(eng.active) == slots, f"engine_compare {name} "
                  f"slots={slots}: {len(eng.active)} active")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(timed):
                eng.step()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {"decode_attention": decode_attention_cuda.launches,
                        **dict(flash_attention_cuda.variant_launches)}
            steps = warm + timed
            want = cfg.n_layers * steps * (slots if name == "dict" else 1)
            check(launches["decode_attention"] == want,
                  f"engine_compare {name} slots={slots}: decode launches "
                  f"{launches}, want {want}")
            check(launches == {"decode_attention": want,
                               "wgmma": cfg.n_layers * slots, "tf32x3": 0},
                  f"engine_compare {name} slots={slots}: flash launches "
                  f"{launches}, want {cfg.n_layers * slots} wgmma")
            streams[name] = [list(r.generated) for _, r in
                             sorted(eng.active.items())]
            for s in streams[name]:
                check(len(s) == steps + 1 and all(0 <= t < cfg.vocab
                                                  for t in s),
                      f"engine_compare {name}: a stream of {len(s)} tokens "
                      "or a token out of vocab")
            row[f"{name}_step_ms"] = 1e3 * dt / timed
            row[f"{name}_tokens_per_s"] = slots * timed / dt
            row[f"{name}_launches"] = launches
            del eng
        row["speedup"] = row["dict_step_ms"] / row["stacked_step_ms"]
        pairs = [(a, b) for x, y in zip(streams["dict"], streams["stacked"])
                 for a, b in zip(x, y)]
        row["greedy_agreement"] = sum(a == b for a, b in pairs) / len(pairs)
        res[f"slots={slots}"] = row
    check(bool(model.flag), "engine_compare: non-finite logits")
    log(json.dumps(res))
    return res


def _e11_agent(starts=None):
    """The RASK agent class of e11's runs: it records every plan vector and
    the random starts' uniforms it drew for each seed (``starts``), or,
    given such a table, takes its uniforms from there, so that a twin on
    another device draws the same starts."""
    import numpy as np

    from repro_torch.core import RASKAgent

    class Agent(RASKAgent):
        def _plan(self, a):
            self.plans.append(np.array(a, np.float32))
            return super()._plan(a)

        def _start_uniforms(self, seed):
            if starts is None:
                u = super()._start_uniforms(seed)
                self.starts[seed] = u
                return u
            self._gen.manual_seed(seed)
            return torch.as_tensor(starts[seed], device=self.device)
    return Agent


def _e11_run(dev, base, agent_cls=None):
    """One e11 loop (``agent_cls=None``: the fixed equal split with the
    accountant advancing; else a RASK agent with the accountant attached)
    on ``dev`` over ``real_serving_scenario``. Returns the platform, the
    cycle records, the agent, each service's applied (chips, context,
    rung) after each cycle, each solved decide's runtime and the wall
    seconds."""
    from repro_torch.core import RaskConfig
    from repro_torch.env import real_serving_scenario
    from repro_torch.serve import run_serving_loop

    plat, patterns, sids, knowledge, acct = real_serving_scenario(
        arch="gemma3-1b", duration_s=E11_SECONDS, capacity_chips=E11_CHIPS,
        base=base, device=dev)
    agent = None
    if agent_cls is not None:
        agent = agent_cls(plat, knowledge,
                          RaskConfig(resource="chips", xi=E11_XI), seed=0,
                          device=dev)
        agent.plans, agent.starts = [], {}
        agent.attach_accountant(acct)
    for sid in sids:                  # the first rung's weights, unclocked
        plat.service(sid).backend._engine()
    applied, runtimes = [], []

    def on_cycle(rec):
        applied.append([(plat.assignment(s)["chips"],
                         plat.service(s).backend.context,
                         plat.service(s).backend.rung) for s in sids])
        if not rec.explored and agent is not None:
            runtimes.append(agent.last_decision.runtime_s)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = run_serving_loop(plat, patterns, agent=agent, duration_s=
                            E11_SECONDS, cycle_s=10.0, on_cycle=on_cycle,
                            accountant=None if agent else acct)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return plat, hist, agent, applied, runtimes, time.perf_counter() - t0


def _engines(plat):
    """(rung, engine) of every engine the platform's services built."""
    return [(r, e) for s in plat.services()
            for r, e in plat.service(s).backend._engines.items()]


def _max_chips(applied):
    return max(sum(c for c, _, _ in cycle) for cycle in applied)


def _compared(plat, hist, agent, applied):
    """What a card run and its CPU twin are held to: the cycles, the
    ledgers, the drops, the most chips applied, the context and rung steps
    applied each cycle, and the plans."""
    return {"cycles": [(r.t, r.fulfillment, r.per_service) for r in hist],
            "post": _post_mean(hist),
            "ledger": {sid: [(r.rid, len(r.prompt)) for r in
                             plat.service(sid).backend.ledger]
                       for sid in plat.services()},
            "dropped": [plat.service(s).backend.dropped
                        for s in plat.services()],
            "max_chips": _max_chips(applied),
            "steps_applied": [[(x, r) for _, x, r in cycle]
                              for cycle in applied],
            "plans": agent.plans if agent is not None else []}


def _post_mean(hist):
    import numpy as np
    return float(np.mean([r.fulfillment for r in hist[E11_XI:]]))


def _e11_cpu(starts):
    """The CPU twin of an e11 run at ``repro``'s setting (smoke cut,
    float32), run in a child process that never touches the card:
    ``starts=None`` is the fixed run, else the card agent's uniforms by
    seed (numpy arrays), which the twin's agent takes as its own."""
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    cls = _e11_agent(starts) if starts is not None else None
    plat, hist, agent, applied, _, wall = _e11_run(torch.device("cpu"),
                                                   None, cls)
    return {**_compared(plat, hist, agent, applied), "wall_s": wall}


# solved plans, card vs CPU, as a share of each coordinate's box: both fit
# their own models on the same telemetry, in float32 with sums in another
# order, from 6-12 rows of 10 terms, and the solve carries the fits'
# difference into the plan
E11_PLAN_TOL = 2e-3


def phase_serving_loop(dev):
    """e11's loop stage at full width, one local:global period deep: 2
    served gemma3-1b services (bf16, rung ladder d_model 288/576/864/1152)
    on 6 chips, bursty load, the fixed split and the RASK agent, each
    ``E11_SECONDS`` simulated seconds.
    Then the RASK kernels at the shapes the loop gave them, a profile of a
    decode step at the lowest and highest rung that ran, and last, with
    nothing on the card timed, each run's CPU twin: the same loop run by
    the port on the CPU at ``repro``'s e11 setting (smoke cut, float32),
    the RASK twin drawing the card agent's random starts (by seed, from
    the card's generator)."""
    import gc
    import multiprocessing

    import numpy as np

    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     reset_launches)
    from repro_torch.kernels.rask_objective import (
        rask_objective_backward_cuda, rask_objective_forward_cuda)

    cfg = gemma_period()                       # full width, bf16

    def counts():
        return {"decode_attention": decode_attention_cuda.launches,
                "flash_wgmma": flash_attention_cuda.variant_launches["wgmma"],
                "flash_tf32x3":
                    flash_attention_cuda.variant_launches["tf32x3"],
                "rask_objective": rask_objective_forward_cuda.launches,
                "rask_objective_grad": rask_objective_backward_cuda.launches}

    def zero():
        decode_attention_cuda.launches = 0
        reset_launches()
        rask_objective_forward_cuda.launches = 0
        rask_objective_backward_cuda.launches = 0

    def tokens_in_vocab(plat):
        for s in plat.services():
            svc = plat.service(s).backend
            reqs = list(svc.ledger)
            for e in svc._engines.values():
                reqs += list(e.active.values()) + e.queue
            check(all(0 <= t < cfg.vocab for r in reqs for t in r.generated),
                  f"serving_loop: {s} generated a token out of vocab")

    torch.cuda.reset_peak_memory_stats()
    res = {"phase": "serving_loop", "model": cfg.name, "dtype": cfg.dtype,
           "services": 2, "chips": E11_CHIPS, "seconds": E11_SECONDS,
           "xi": E11_XI, "cycle_s": 10.0}
    card = {}
    for name, cls in (("fixed", None), ("rask", _e11_agent())):
        zero()
        with PlainOnCard() as plain:
            plat, hist, agent, applied, runtimes, wall = _e11_run(
                dev, cfg, cls)
            launches = counts()
        engines = _engines(plat)
        steps = sum(e.steps for _, e in engines)
        admissions = sum(e.admissions for _, e in engines)
        step_ms = {}
        for r, e in engines:
            step_ms.setdefault(r, []).extend(1e3 * x for x in e.step_s)
        check(sum(map(len, step_ms.values())) == steps,
              f"serving_loop {name}: step times of {steps} steps not kept")
        tokens_in_vocab(plat)
        solved = len(runtimes)        # 0 in the fixed run: no agent
        want = {"decode_attention": cfg.n_layers * steps,
                "flash_wgmma": cfg.n_layers * admissions,
                "flash_tf32x3": 0,
                "rask_objective": solved,
                "rask_objective_grad": 32 * solved}
        row = {"cycles": len(hist), "solved_decides": solved,
               "engine_steps": steps, "admissions": admissions,
               "launches": launches, "plain_calls_on_card": plain.calls,
               "wall_s": wall,
               "post_explore_fulfillment": _post_mean(hist),
               "fulfillment": [r.fulfillment for r in hist],
               "alerts": [r.alerts for r in hist],
               "max_chips_applied": _max_chips(applied),
               "dropped": [plat.service(s).backend.dropped
                           for s in plat.services()],
               "step_ms_median_by_rung": {
                   r: statistics.median(v) for r, v in sorted(step_ms.items())},
               "steps_by_rung": {r: len(v) for r, v in
                                 sorted(step_ms.items())}}
        if solved:                # the first pays one-off start costs
            ms = [1e3 * t for t in runtimes]
            row["decide_ms"] = ms
            row["decide_ms_median_after_first"] = statistics.median(ms[1:])
        res[name] = row
        log(json.dumps({name: row}))
        check(launches == want, f"serving_loop {name}: launches "
              f"{launches}, want {want}")
        check(all(v > 0 for k, v in want.items() if k != "flash_tf32x3"
                  and (cls is not None or not k.startswith("rask"))),
              f"serving_loop {name}: a kernel of the path never ran {want}")
        check(not any(plain.calls.values()),
              f"serving_loop {name}: plain versions ran on the card "
              f"{plain.calls}")
        check(row["max_chips_applied"] <= E11_CHIPS + 1e-6,
              f"serving_loop {name}: {row['max_chips_applied']} chips "
              "applied")
        card[name] = _compared(plat, hist, agent, applied)
        if cls is None:
            del plat, hist, engines       # free the fixed run's services
            gc.collect()
            torch.cuda.empty_cache()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # the RASK kernels at the shapes e11 gives them (2 services, 6 SLOs,
    # features chips/context/rung): the agent's own tables and models, the
    # loop's last load, as many candidates as the solver's starts
    check(agent.problem.dim == 6 and len(agent.problem.specs) == 2,
          f"serving_loop: the agent's problem is {agent.problem.dim}-d")
    res["rask_kernels"] = _rask_cases(agent, hist[-1].t, agent.cfg.pgd_starts,
                                      11, "e11_S2_K%d" % agent.cfg.pgd_starts)

    # where a decode step's time goes at the lowest and highest rung that
    # ran (after the counters were read)
    by_rung = dict(_engines(plat))
    ran = sorted(res["rask"]["steps_by_rung"])
    res["trace"] = {f"rung{r}": profile_window(f"decode_step_rung{r}",
                                               by_rung[r].step, 3)
                    for r in sorted({ran[0], ran[-1]})}

    # the CPU twins, with nothing on the card timed beside them
    starts = {seed: u.cpu().numpy() for seed, u in agent.starts.items()}
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        jobs = {"fixed": pool.apply_async(_e11_cpu, (None,)),
                "rask": pool.apply_async(_e11_cpu, (starts,))}
        cpu = {name: job.get(timeout=600) for name, job in jobs.items()}
    for name, twin in cpu.items():
        res[name].update(cpu_wall_s=twin["wall_s"],
                         post_explore_fulfillment_cpu=twin["post"])
        check(twin["max_chips"] <= E11_CHIPS + 1e-6,
              f"serving_loop {name}: {twin['max_chips']} chips applied on "
              "the CPU")
    check(card["fixed"]["cycles"] == cpu["fixed"]["cycles"],
          "serving_loop fixed: the card's cycles differ from the CPU's")
    check(card["fixed"]["ledger"] == cpu["fixed"]["ledger"]
          and card["fixed"]["dropped"] == cpu["fixed"]["dropped"],
          "serving_loop fixed: ledgers or drops differ from the CPU's")
    got, want = card["rask"], cpu["rask"]
    row = res["rask"]
    check(row["solved_decides"] >= 5,
          f"serving_loop rask: {row['solved_decides']} solved decides")
    check(len(got["plans"]) == len(want["plans"]) and all(
        np.array_equal(a, b) for a, b in zip(got["plans"][:E11_XI],
                                             want["plans"][:E11_XI])),
          "serving_loop rask: exploration plans differ from the CPU's")
    span = agent.problem.upper - agent.problem.lower
    diff = np.abs(np.array(got["plans"][E11_XI:])
                  - np.array(want["plans"][E11_XI:]))
    row["solved_plans_max_abs_diff"] = float(diff.max())
    row["solved_plans_max_span_share"] = float((diff / span).max())
    row["solved_plans_tolerance"] = E11_PLAN_TOL
    check(row["solved_plans_max_span_share"] <= E11_PLAN_TOL,
          f"serving_loop rask: solved plans differ from the CPU's by up to "
          f"{row['solved_plans_max_span_share']} of a coordinate's range")
    # reported, not held: a context or rung within the plans' difference of
    # a step's edge may land on either side of it
    row["context_rung_steps_equal"] = (got["steps_applied"]
                                       == want["steps_applied"])
    mask = agent.problem.resource_mask
    check(all(a[mask].astype(np.float64).sum() <= E11_CHIPS * (1 + 1e-6)
              for a in got["plans"]),
          "serving_loop rask: a plan asks for more than 6 chips")
    gap = abs(row["post_explore_fulfillment"] - want["post"])
    row["fulfillment_gap"], row["tolerance"] = gap, 0.03
    check(gap <= 0.03, f"serving_loop rask: fulfillment "
          f"{row['post_explore_fulfillment']} on the card vs "
          f"{want['post']} on the CPU")
    res["auto_minus_fixed_card"] = (res["rask"]["post_explore_fulfillment"]
                                    - res["fixed"]["post_explore_fulfillment"])
    res["auto_minus_fixed_cpu"] = (
        res["rask"]["post_explore_fulfillment_cpu"]
        - res["fixed"]["post_explore_fulfillment_cpu"])
    log(json.dumps({k: v for k, v in res.items()
                    if k not in ("fixed", "rask")}))
    return res


# -- the multi-host fleet: bucketed solve, placement, failover -----------------------

# repro's benchmark fleets (benchmarks/e6_scalability.py:47, :57 and
# benchmarks/e8_placement.py:47): (hosts, services a host, cores a host)
SOLVE_FLEET = ((16, 2, 4.0), (8, 8, 16.0))
SCALE_FLEET = ((100, 10, 20.0),)
SCALE_MOVER_HOSTS, SCALE_TARGETS = 25, 4
# a row's score, card vs CPU from the same uniforms and models: 1e-3
# relative (tests/test_torch_fleet_solver.py's bar against repro). A start's
# ascent can cross a branch (the projection's bisection, the min(ratio, 1)
# clip) at a float-order difference and end elsewhere: at e8's placement
# batch one start of 6,600 did so at step 23 of 32 (1.7e-3 on its row).
# So at most one row in 1,000 (at least one) may pass the bar, and the
# median gap must stay at float32 rounding (1e-6).
FLEET_REL = 1e-3
FAILOVER_SECONDS = 1200.0


def _solve_fleet(fleet, dev):
    """e6's synthetic fleet (``_solve_fleet``): tiers of (hosts, services a
    host, cores a host) of paper-like 3-parameter services, one degree-2
    throughput model fitted once (300 seeded samples) and shared; load 50
    rps each; a warm start projected onto the whole budget. Returns
    (problem, host_of, caps, models, rps, x0, subsets_of)."""
    import numpy as np

    from repro_torch.core.regression import BatchedFitPlan, StackedModels
    from repro_torch.core.slo import SLO
    from repro_torch.core.solver import ServiceSpec, SolverProblem

    specs, host_of, caps = [], {}, {}
    for tier, (n_hosts, n_svc, cores) in enumerate(fleet):
        for h in range(n_hosts):
            hostname = f"tier{tier}-{h}"
            caps[hostname] = cores
            for i in range(n_svc):
                s = ServiceSpec(
                    name=f"t{tier}h{h}s{i}",
                    param_names=("cores", "data_quality", "model_size"),
                    lower=(0.1, 100.0, 1.0), upper=(8.0, 1000.0, 4.0),
                    resource_mask=(True, False, False),
                    slos=(SLO("data_quality", 800.0, 0.5),
                          SLO("model_size", 3.0, 0.2),
                          SLO("completion", 1.0, 1.0)),
                    relation_features=(("tp_max", (0, 1, 2)),))
                specs.append(s)
                host_of[s.name] = hostname
    problem = SolverProblem(specs, device=dev)
    rng = np.random.default_rng(0)
    X = np.c_[rng.uniform(0.1, 8, 300), rng.uniform(100, 1000, 300),
              rng.uniform(1, 4, 300)].astype(np.float32)
    Y = (20 * X[:, 0] - X[:, 1] / 100.0 + 3 * X[:, 2]).astype(np.float32)
    one = BatchedFitPlan([dict(n_features=3, degree=2,
                               x_scale=[8.0, 1000.0, 4.0])],
                         row_capacity=512, device=dev).fit([(X, Y)])
    R = len(specs)
    sm = StackedModels(*(t.expand(R, *t.shape[1:]).contiguous() for t in (
        one.w, one.exponents, one.term_mask, one.x_scale)), one.max_degree)
    rps = np.full(R, 50.0, np.float32)
    x0 = problem.random_assignment(np.random.default_rng(1),
                                   float(sum(caps.values())))
    return problem, host_of, caps, sm, rps, x0


def _scale_candidates(problem, host_of, caps, x0):
    """e8's capped candidate set (``scale_bench``): a stay-put row a host,
    then each resident of the 25 most loaded hosts on each of the 4 least
    loaded ones."""
    residents = {h: [] for h in caps}
    for i, s in enumerate(problem.specs):
        residents[host_of[s.name]].append(i)
    load = {h: sum(float(x0[problem.offsets[i]]) for i in residents[h])
            / caps[h] for h in caps}
    by_load = sorted(caps, key=lambda h: (load[h], h))
    targets, movers = by_load[:SCALE_TARGETS], by_load[-SCALE_MOVER_HOSTS:]
    subsets = [residents[h] for h in sorted(caps)]
    caps_list = [caps[h] for h in sorted(caps)]
    for h in movers:
        for i in residents[h]:
            for t in targets:
                subsets.append(sorted(residents[t] + [i]))
                caps_list.append(caps[t])
    return subsets, caps_list


def _rask_counts():
    from repro_torch.kernels.rask_objective import (
        rask_objective_backward_cuda, rask_objective_forward_cuda)
    return (rask_objective_forward_cuda.launches,
            rask_objective_backward_cuda.launches)


def _zero_rask_counts():
    from repro_torch.kernels.rask_objective import (
        rask_objective_backward_cuda, rask_objective_forward_cuda)
    rask_objective_forward_cuda.launches = 0
    rask_objective_backward_cuda.launches = 0


def _host_feasible(problem, a, host_of, caps):
    """Each host's resource sum within its budget, every coordinate in its
    box."""
    import numpy as np
    used = dict.fromkeys(caps, 0.0)
    for i, s in enumerate(problem.specs):
        used[host_of[s.name]] += float(a[problem.offsets[i]])
    return (all(used[h] <= caps[h] for h in caps)
            and bool(np.all(a >= problem.lower - 1e-5))
            and bool(np.all(a <= problem.upper + 1e-5)))


def _rel_gaps(got, want):
    import numpy as np
    return np.abs(got - want) / np.maximum(np.abs(want), 1e-6)


def _rel_gap(got, want):
    return float(_rel_gaps(got, want).max())


def _cpu_agreement(got, want):
    """Rows of card scores against the CPU's: the worst and median gaps,
    the rows past ``FLEET_REL`` and how many may be (see there)."""
    import numpy as np
    gaps = _rel_gaps(got, want)
    return {"max": float(gaps.max()), "median": float(np.median(gaps)),
            "rows_over": int((gaps > FLEET_REL).sum()),
            "rows_over_allowed": max(1, len(gaps) // 1000),
            "worst_rows": [int(i) for i in np.argsort(-gaps)[:3]]}


def _check_cpu_agreement(agree, what):
    check(agree["rows_over"] <= agree["rows_over_allowed"]
          and agree["median"] <= 1e-6,
          f"{what}: card vs CPU {agree}")


def _timed(fn, reps=5):
    """Median wall ms of ``fn`` ending in a synchronize, after a warm
    call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def phase_fleet_solve(dev):
    """The bucketed fleet solve at e6's sizes and placement scoring at e8's
    scale point, on the card against the per-row loop and the CPU twin fed
    the same uniforms. Returns the report and the problems (their tables
    feed fleet_kernels)."""
    import numpy as np

    from repro_torch.core.solver import (FleetSolverProblem,
                                         PlacementProblem, SolverProblem)

    cpu = torch.device("cpu")
    res, keep = {"phase": "fleet_solve"}, {}
    for name, fleet in (("hetero", SOLVE_FLEET), ("scale", SCALE_FLEET)):
        # e6's fleets; the scale fleet's host_of and caps stay for e8's
        # candidates below
        problem, host_of, caps, sm, rps, x0 = _solve_fleet(fleet, dev)
        fp = FleetSolverProblem(problem, host_of, caps)
        nb = len(fp.buckets)
        u = fp.uniforms(torch.Generator(dev).manual_seed(7), 6)
        _zero_rask_counts()
        with PlainOnCard() as plain:
            a, sc = fp.solve_many(sm, rps, x0, u=u)
            torch.cuda.synchronize()
            launches = _rask_counts()
            t0 = time.perf_counter()
            a_seq, sc_seq = fp.solve_sequential(sm, rps, x0, u=u)
            seq_ms = 1e3 * (time.perf_counter() - t0)   # one run: it is long
        fp_cpu = FleetSolverProblem(SolverProblem(problem.specs, device=cpu),
                                    host_of, caps)
        sm_cpu = type(sm)(sm.w.cpu(), sm.exponents.cpu(), sm.term_mask.cpu(),
                          sm.x_scale.cpu(), sm.max_degree)
        a_cpu, sc_cpu = fp_cpu.solve_many(sm_cpu, rps, x0,
                                          u=[x.cpu() for x in u])
        x0_t = torch.from_numpy(x0).to(dev)
        rps_t = torch.from_numpy(rps).to(dev)

        def solve():
            return fp.solve_rows(x0_t, u, sm, rps_t, n_starts=6, iters=32,
                                 lr=0.18)
        row = {"services": len(problem.specs), "hosts": len(fp.hosts),
               "buckets": [[len(bk.hosts), *bk.key] for bk in fp.buckets],
               "ctas_per_launch": [6 * len(bk.hosts) for bk in fp.buckets],
               "launches": {"rask_objective": launches[0],
                            "rask_objective_grad": launches[1]},
               "plain_calls_on_card": plain.calls,
               "score_rel_gap_sequential": _rel_gap(sc, sc_seq),
               "score_rel_gap_cpu": _cpu_agreement(sc, sc_cpu),
               "feasible": _host_feasible(problem, a, host_of, caps),
               "feasible_cpu": _host_feasible(problem, a_cpu, host_of, caps),
               "solve_many_ms": _timed(lambda: fp.solve_many(sm, rps, x0,
                                                             u=u)),
               "solve_sequential_ms": seq_ms,
               "trace": profile_window(f"fleet_solve_{name}", solve, 3)}
        res[name] = row
        log(json.dumps({name: row}))
        check(launches == (nb, 32 * nb), f"fleet_solve {name}: launches "
              f"{launches} for {nb} buckets")
        check(not any(plain.calls.values()),
              f"fleet_solve {name}: plain versions ran on the card")
        check(row["feasible"] and row["feasible_cpu"],
              f"fleet_solve {name}: a host's plan exceeds its budget")
        check(row["score_rel_gap_sequential"] <= 1e-4,
              f"fleet_solve {name}: batched vs per-row "
              f"{row['score_rel_gap_sequential']}")
        _check_cpu_agreement(row["score_rel_gap_cpu"], f"fleet_solve {name}")
        keep[name] = (problem, fp, sm, rps, x0)

    # placement scoring at e8's scale point: 1,100 candidates, n_starts 6
    # and 32 iterations as scale_bench scores them, then the agent's budget
    problem, fp, sm, rps, x0 = keep["scale"]
    subsets, caps_list = _scale_candidates(problem, host_of, caps, x0)
    pp = PlacementProblem(problem, subsets, caps_list)
    nb = len(pp.buckets)
    u = pp.uniforms(torch.Generator(dev).manual_seed(8), 6)
    _zero_rask_counts()
    with PlainOnCard() as plain:
        sc = pp.scores(sm, rps, x0, u=u)
        torch.cuda.synchronize()
        launches = _rask_counts()
    pp_cpu = PlacementProblem(SolverProblem(problem.specs, device=cpu),
                              subsets, caps_list)
    sm_cpu = type(sm)(sm.w.cpu(), sm.exponents.cpu(), sm.term_mask.cpu(),
                      sm.x_scale.cpu(), sm.max_degree)
    sc_cpu = pp_cpu.scores(sm_cpu, rps, x0, u=[x.cpu() for x in u])
    u4 = pp.uniforms(torch.Generator(dev).manual_seed(9), 4)
    x0_t, rps_t = torch.from_numpy(x0).to(dev), torch.from_numpy(rps).to(dev)
    row = {"candidates": pp.n_candidates,
           "buckets": [[len(bk.hosts), *bk.key] for bk in pp.buckets],
           "ctas_per_launch": [6 * len(bk.hosts) for bk in pp.buckets],
           "launches": {"rask_objective": launches[0],
                        "rask_objective_grad": launches[1]},
           "plain_calls_on_card": plain.calls,
           "score_rel_gap_cpu": _cpu_agreement(sc, sc_cpu),
           "scores_ms": _timed(lambda: pp.scores(sm, rps, x0, u=u)),
           "scores_ms_agent_budget": _timed(lambda: pp.scores(
               sm, rps, x0, n_starts=4, iters=16, u=u4)),
           "trace": profile_window("placement_scale", lambda: pp.score_rows(
               x0_t, u, sm, rps_t, n_starts=6, iters=32, lr=0.18), 3)}
    res["placement"] = row
    keep["placement"] = (problem, pp, sm, rps, x0)
    log(json.dumps({"placement": row}))
    check(launches == (nb, 32 * nb), f"fleet_solve placement: launches "
          f"{launches} for {nb} buckets")
    check(not any(plain.calls.values()),
          "fleet_solve placement: plain versions ran on the card")
    _check_cpu_agreement(row["score_rel_gap_cpu"], "fleet_solve placement")
    return res, keep


def _failover_agent(dev, record=None):
    """The RASK agent class of the failover runs. On the card (``record``
    a dict) it notes each solved decide's and each placement snapshot's
    bucket count; the CPU twin (``record=None``) draws its random starts
    from generators on ``dev`` seeded as the card agent's are, so both
    start from the same uniforms wherever their layouts agree."""
    from repro_torch.core import RASKAgent

    class Agent(RASKAgent):
        def _plan(self, a):
            self.plans.append(a.copy())
            return super()._plan(a)

        def _start_uniforms(self, seed):
            if record is not None:
                record["decide_buckets"].append(
                    len(self.fleet_problem.buckets))
                return super()._start_uniforms(seed)
            self._gen.manual_seed(seed)
            g = torch.Generator(dev).manual_seed(seed)
            return [u.cpu() for u in self.fleet_problem.uniforms(
                g, self.cfg.pgd_starts)]

        def _score_uniforms(self, pp):
            if record is not None:
                record["snapshot_buckets"].append(len(pp.buckets))
                return super()._score_uniforms(pp)
            g = torch.Generator(dev).manual_seed(0)
            return [u.cpu() for u in pp.uniforms(g, self.cfg.score_starts)]
    return Agent


def _failover_run(dev, agent_cls):
    """e8's failover stage: the tiered fleet, 1200 s, the hub drained at
    720 s, ``RaskConfig(xi=20, eta=0.0, rebalance_every=3)``."""
    from repro_torch.core import RaskConfig
    from repro_torch.env import failover_scenario

    env, knowledge, events = failover_scenario(duration_s=FAILOVER_SECONDS,
                                               seed=0)
    agent = agent_cls(env.platform, knowledge,
                      RaskConfig(xi=20, eta=0.0, rebalance_every=3), seed=0,
                      device=dev)
    agent.plans = []
    t0 = time.perf_counter()
    hist = env.run(agent, duration_s=FAILOVER_SECONDS, events=events)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return env, agent, events, hist, time.perf_counter() - t0


def phase_failover(dev):
    """e8's failover stage on the card, the CPU twin after it."""
    import numpy as np

    from repro_torch.core.api import REASON_CAPACITY

    record = {"decide_buckets": [], "snapshot_buckets": []}
    _zero_rask_counts()
    with PlainOnCard() as plain:
        env, agent, events, hist, wall = _failover_run(
            dev, _failover_agent(dev, record))
        launches = _rask_counts()
    fail_t = events[0].t
    xi = agent.cfg.xi
    pre = [h.fulfillment for h in hist if not h.explored and h.t <= fail_t]
    post = [h.fulfillment for h in hist if h.t > fail_t]
    settled = [h.fulfillment for h in hist if h.t > fail_t + 100.0]
    clips = sum(1 for h in hist for o in h.receipt.clipped()
                if o.reason == REASON_CAPACITY)
    states = env.platform.window_states(since=env.t - 50.0, until=env.t)
    answering = sum(bool(states.get(s)) for s in env.platform.services())
    d, sn = sum(record["decide_buckets"]), sum(record["snapshot_buckets"])
    cfg = agent.cfg
    want = (d + sn, cfg.pgd_iters * d + cfg.score_iters * sn)
    solved = [1e3 * h.runtime_s for h in hist if not h.explored]
    obs = agent.observe(env.t)
    snapshot_ms = _timed(lambda: agent.placement_scores(obs))
    agent.cfg.rebalance_every = 0     # decides alone in the decide trace
    obs_iter = iter([agent.observe(env.t) for _ in range(4)])
    res = {"phase": "failover", "seconds": FAILOVER_SECONDS,
           "fail_t": fail_t, "xi": xi, "rebalance_every": 3,
           "hosts_after": sorted(h.host for h in env.platform.hosts()),
           "services_after": len(env.platform.services()),
           "capacity_clips": clips, "telemetry_answering": answering,
           "moves": agent.moves_total, "wall_s": wall,
           "launches": {"rask_objective": launches[0],
                        "rask_objective_grad": launches[1]},
           "launches_expected": want,
           "solved_decides": len(record["decide_buckets"]),
           "snapshots": len(record["snapshot_buckets"]),
           "plain_calls_on_card": plain.calls,
           "mean_pre_failover": float(np.mean(pre)),
           "min_post_failover": float(np.min(post)),
           "mean_recovered": float(np.mean(settled)),
           "post_explore_fulfillment": float(np.mean(
               [h.fulfillment for h in hist[xi:]])),
           "fulfillment": [h.fulfillment for h in hist],
           "decide_ms": solved,
           "decide_ms_median_after_first": statistics.median(solved[1:]),
           "snapshot_ms": snapshot_ms,
           "trace_decide": profile_window(
               "failover_decide", lambda: agent.decide(next(obs_iter)), 3),
           "trace_snapshot": profile_window(
               "failover_snapshot", lambda: agent.placement_scores(obs), 3)}
    log(json.dumps({k: v for k, v in res.items() if k != "fulfillment"}))
    check(res["hosts_after"] == ["camera-0", "gateway-0"]
          and res["services_after"] == 9,
          f"failover: {res['hosts_after']}, {res['services_after']} "
          "services after the drain")
    check(clips == 0, f"failover: {clips} capacity clips")
    check(answering == 9, f"failover: telemetry of {answering}/9 services")
    check(launches == want, f"failover: launches {launches}, want {want}")
    check(not any(plain.calls.values()),
          "failover: plain versions ran on the card")

    # the CPU twin, its starts drawn from the card's generators
    cpu_env, cpu_agent, _, cpu_hist, cpu_wall = _failover_run(
        torch.device("cpu"), _failover_agent(dev))
    res["cpu_wall_s"] = cpu_wall
    res["post_explore_fulfillment_cpu"] = float(np.mean(
        [h.fulfillment for h in cpu_hist[xi:]]))
    res["hosts_after_cpu"] = {h.host: sorted(h.services())
                              for h in cpu_env.platform.hosts()}
    res["placement_equal_cpu"] = res["hosts_after_cpu"] == {
        h.host: sorted(h.services()) for h in env.platform.hosts()}
    res["moves_cpu"] = cpu_agent.moves_total
    gap = abs(res["post_explore_fulfillment"]
              - res["post_explore_fulfillment_cpu"])
    res["fulfillment_gap"], res["tolerance"] = gap, 0.03
    explored_equal = all(np.array_equal(a, b) for a, b in zip(
        agent.plans[:xi], cpu_agent.plans[:xi]))
    res["exploration_plans_equal_cpu"] = explored_equal
    log(json.dumps({k: v for k, v in res.items() if k.endswith("_cpu")
                    or k in ("fulfillment_gap", "tolerance")}))
    check(explored_equal, "failover: exploration plans differ from the CPU's")
    check(gap <= 0.03, f"failover: fulfillment {res['post_explore_fulfillment']}"
          f" on the card vs {res['post_explore_fulfillment_cpu']} on the CPU")
    return res, env, agent


def _batched_args(bk, sm, rps_g, K, gen):
    """A bucket's batched objective inputs: K random candidates a row in
    its padded box (padded slots 0), its tables, its gathered models and
    its rows' loads."""
    t = bk.tables
    u = torch.rand((len(bk.hosts), K, t.lower.shape[1]), generator=gen,
                   device=gen.device)
    A = (t.lower[:, None] + u * (t.upper - t.lower)[:, None]).contiguous()
    g = bk.gather_models(sm)
    return (A, t.rel_gather, g.w, g.exponents, g.term_mask, g.x_scale,
            t.slo_kind, t.slo_service, t.slo_weight, t.slo_target,
            t.slo_pidx, t.slo_ridx, rps_g[bk.svc_take].contiguous()), \
        dict(n_services=bk.n_services_max, max_degree=g.max_degree)


def _batched_cases(bk, sm, rps_g, K, case):
    """The batched forward and backward on one bucket's rows, held against
    their batched plain versions at ``RASK_TOL`` of scale and timed beside
    the per-row loop of the un-batched launch; one row each."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rask_objective import (
        rask_objective_backward_cuda, rask_objective_forward_cuda)

    dev = bk.tables.lower.device
    gen = torch.Generator(dev).manual_seed(K + len(bk.hosts))
    args, kw = _batched_args(bk, sm, rps_g, K, gen)
    A, S, B = args[0], kw["n_services"], len(bk.hosts)
    ct = torch.randn((B, K, S), generator=gen, device=dev)
    rows_of = [[t[j] for t in args] for j in range(B)]
    n0 = _rask_counts()
    fwd = rask_objective_forward_cuda(*args, n_services=S)
    bwd = rask_objective_backward_cuda(A, ct, *args[1:], n_services=S)
    check(_rask_counts() == (n0[0] + 1, n0[1] + 1),
          f"fleet_kernels {case}: not one launch each")
    want_f = ref.rask_objective_reference(*args, **kw)
    want_b = ref.rask_objective_grad(A, ct, *args[1:], **kw)
    torch.cuda.synchronize()
    out = []
    for name, got, want, backward in (
            ("rask_objective", fwd, want_f, False),
            ("rask_objective_grad", bwd, want_b, True)):
        err = (got - want).abs().max().item()
        bar = RASK_TOL * (1.0 + want.abs().max().item())
        check(bool(torch.isfinite(got).all()),
              f"{name} {case}: non-finite output")
        check(err <= bar, f"{name} {case}: error {err} > {bar}")
        nbytes, flops = _objective_work(args, S, backward)
        if backward:
            def call():
                return rask_objective_backward_cuda(A, ct, *args[1:],
                                                    n_services=S)

            def loop():
                for j, r in enumerate(rows_of):
                    rask_objective_backward_cuda(r[0], ct[j], *r[1:],
                                                 n_services=S)

            def plain():
                return ref.rask_objective_grad(A, ct, *args[1:], **kw)
        else:
            def call():
                return rask_objective_forward_cuda(*args, n_services=S)

            def loop():
                for r in rows_of:
                    rask_objective_forward_cuda(*r, n_services=S)

            def plain():
                return ref.rask_objective_reference(*args, **kw)
        row = {"kernel": name, "case": case, "rows": B, "K": K,
               "ctas": B * K, "services": S, "dim": A.shape[2],
               "relations": args[3].shape[1], "terms": args[3].shape[2],
               "slos": args[6].shape[1], "max_abs_err": err,
               "tolerance": bar, "bytes": nbytes, "flops": flops,
               "bound": bound_ms(nbytes, flops, "float32")}
        row["ms"], row["call_ms"] = time_ms([call], 100)
        row["plain_ms"], row["plain_call_ms"] = time_ms([plain], 10)
        # the per-row loop: B launches queued as a caller queues them
        # (CUDA events around the loop, host included: past about a
        # thousand launches the queue blocks the host, so no device-only
        # time is taken)
        loop()
        torch.cuda.synchronize()
        row["per_row_loop_ms"] = _events_ms([loop], 3)[0]
        row["kernels_per_call"], row["kernel_names"] = kernels_per_call(call)
        check(row["kernels_per_call"] == 1,
              f"{name} {case}: {row['kernels_per_call']} kernels a call")
        row["library_ms"] = None
        out.append(row)
        log(f"{name} {case}: {row}")
    return out


def phase_fleet_kernels(dev, keep, failover_agent):
    """The batched RASK kernels at the fleet path's shapes: the hetero
    fleet's two buckets (16 x 6 and 8 x 6 CTAs), the 100-host fleet (600),
    the 1,100-candidate placement batch at 6 starts (6,600) and at the
    agent's 4 (4,400), and the failover agent's own bucket rows (its
    fitted models, padding included)."""
    cases = []
    for name in ("hetero", "scale"):
        problem, fp, sm, rps, _ = keep[name]
        rps_g = torch.from_numpy(rps).to(dev)
        for bk in fp.buckets:
            cases += _batched_cases(bk, sm, rps_g, 6,
                                    f"{name}_B{len(bk.hosts)}_K6")
    problem, pp, sm, rps, _ = keep["placement"]
    rps_g = torch.from_numpy(rps).to(dev)
    for K in (6, 4):
        for bk in pp.buckets:
            cases += _batched_cases(bk, sm, rps_g, K,
                                    f"placement_B{len(bk.hosts)}_K{K}")
    agent = failover_agent
    rps_g = torch.from_numpy(agent._rps_vector(None)).to(dev)
    for bk in agent.fleet_problem.buckets:
        cases += _batched_cases(bk, agent.stacked, rps_g, agent.cfg.pgd_starts,
                                f"failover_B{len(bk.hosts)}_K"
                                f"{agent.cfg.pgd_starts}")
    res = {"phase": "fleet_kernels", "cases": cases}
    return res


# -- the beyond-paper decide options: pipeline, forecast, budget, transfer ---------

PIPELINE_REPLICAS, PIPELINE_SECONDS, PAIRED_ROUNDS = 16, 400.0, 10
E10_XI, E10_SECONDS, E10_QUIET = 12, 1200.0, 8
TRANSFER_SECONDS, TRANSFER_ARRIVE = 600.0, 400.0
E9_SECONDS = 1200.0


def _syncs_in(fn):
    """The synchronising CUDA calls one call of ``fn`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [str(w.message).splitlines()[0] for w in caught
            if "called a synchronizing" in str(w.message)]


def _dispatch_log(cls):
    """``cls`` noting each solve's layout buckets and budget, each
    placement snapshot's (and its ``PlacementProblem``), each emitted plan
    by round, and each pipelined dispatch's round and the pinned host
    buffer its copy lands in (a reference: nothing more is queued)."""
    class Logged(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.solves, self.snapshots, self.emitted = [], [], []
            self.dispatches, self.last_pp = [], None

        def _queue_copy(self, out):
            host, event = super()._queue_copy(out)
            self.dispatches.append((self.rounds, host))
            return host, event

        def _start_uniforms(self, seed):
            fp = self.fleet_problem
            self.solves.append((len(fp.buckets) if fp is not None else 1,
                                self._budget_starts, self._budget_iters))
            return super()._start_uniforms(seed)

        def _score_uniforms(self, pp):
            self.snapshots.append((len(pp.buckets), self._score_starts,
                                   self._score_iters))
            self.last_pp = pp
            return super()._score_uniforms(pp)

        def _plan(self, a):
            self.emitted.append((self.rounds, a.copy()))
            return super()._plan(a)
    return Logged


def _cuda_starts(cls, dev):
    """``cls`` drawing its random starts on the CPU from a generator on
    ``dev`` seeded as the card agent's is, at the current budget: a CPU
    twin then starts from the card's uniforms."""
    class Twin(cls):
        def _start_uniforms(self, seed):
            self._gen.manual_seed(seed)
            g = torch.Generator(dev).manual_seed(seed)
            if self.fleet_problem is not None:
                return [u.cpu() for u in self.fleet_problem.uniforms(
                    g, self._budget_starts)]
            return torch.rand((max(self._budget_starts - 3, 0),
                               self.problem.dim), generator=g,
                              device=dev).cpu()
    return Twin


def _expect_launches(agent):
    """(forward, backward) launches the agent's logged solves and
    snapshots must have made: a bucket a solve and a snapshot forward,
    ``iters`` a bucket a solve and ``score_iters`` a bucket a snapshot
    backward, at the budget each ran with."""
    solves = agent.solves
    fwd = sum(b for b, _, _ in solves) + sum(b for b, _, _ in agent.snapshots)
    bwd = sum(b * it for b, _, it in solves) \
        + sum(b * it for b, _, it in agent.snapshots)
    return fwd, bwd


def phase_pipeline(dev):
    """e6's ``pipeline_bench`` world on the card: 48 services (16 x the
    paper triple) on 16 hosts of 8 cores, ``RaskConfig(xi=14, eta=0.0)``,
    400 s, synchronous and then pipelined."""
    import numpy as np

    from repro_torch.core import RASKAgent, RaskConfig
    from repro_torch.env import ChurnEvent, EdgeEnvironment, \
        paper_knowledge, paper_profiles

    xi = 14
    res = {"phase": "pipeline", "services": 3 * PIPELINE_REPLICAS,
           "hosts": PIPELINE_REPLICAS, "seconds": PIPELINE_SECONDS, "xi": xi}
    runs = {}
    for mode in ("sync", "pipelined"):
        env = EdgeEnvironment(list(paper_profiles().values()), {"cores": 8.0},
                              replicas=PIPELINE_REPLICAS,
                              hosts=PIPELINE_REPLICAS, seed=0)
        agent = _dispatch_log(RASKAgent)(
            env.platform, paper_knowledge(),
            RaskConfig(xi=xi, eta=0.0, pipeline=mode == "pipelined"),
            seed=0, device=dev)
        torch.cuda.synchronize()
        _zero_rask_counts()
        with PlainOnCard() as plain:
            t0 = time.perf_counter()
            hist = env.run(agent, duration_s=PIPELINE_SECONDS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _rask_counts()
        solved = [h for h in hist if not h.explored and h.runtime_s > 0]
        row = {"median_runtime_ms": 1e3 * statistics.median(
                   h.runtime_s for h in solved),
               "median_dispatch_ms": 1e3 * statistics.median(
                   h.dispatch_s for h in solved),
               "median_collect_ms": 1e3 * statistics.median(
                   h.collect_s for h in solved),
               "mean_fulfillment": float(np.mean(
                   [h.fulfillment for h in hist[xi:]])), "solved": len(solved),
               "wall_s": wall,
               "launches": {"rask_objective": launches[0],
                            "rask_objective_grad": launches[1]},
               "launches_expected": _expect_launches(agent),
               "plain_calls_on_card": plain.calls}
        check(launches == row["launches_expected"],
              f"pipeline {mode}: launches {launches}, want "
              f"{row['launches_expected']}")
        check(not any(plain.calls.values()),
              f"pipeline {mode}: plain versions ran on the card")
        obs = iter([agent.observe(env.t) for _ in range(4)])
        row["trace"] = profile_window(f"{mode}_decide",
                                      lambda: agent.decide(next(obs)), 3)
        row["syncs_in_one_decide"] = _syncs_in(
            lambda: agent.decide(agent.observe(env.t)))
        runs[mode] = (env, agent, hist)
        res[mode] = row
        log(json.dumps({mode: row}))
    sync, piped = res["sync"], res["pipelined"]
    res["hidden_fraction_runs"] = 1.0 - piped["median_runtime_ms"] \
        / sync["median_runtime_ms"]
    # the two runs' medians move with the host clock: time the two agents'
    # decides in turns as well (sync, pipelined, pipelined, sync, ...)
    paired = {"sync": [], "pipelined": []}
    order = ["sync", "pipelined", "pipelined", "sync"] * PAIRED_ROUNDS
    for mode in order:
        env, agent, _ = runs[mode]
        agent.decide(agent.observe(env.t))
        paired[mode].append(1e3 * agent.last_decision.runtime_s)
    res["paired_median_ms"] = {m: statistics.median(v)
                               for m, v in paired.items()}
    res["paired_ms"] = paired
    res["hidden_fraction"] = 1.0 - res["paired_median_ms"]["pipelined"] \
        / res["paired_median_ms"]["sync"]
    res["hidden_fraction_bar_repro"] = 0.5      # e6's acceptance, not held
    env, agent, hist = runs["pipelined"]
    d = agent.problem.dim
    # the one-cycle lag: the plan emitted at round n + 1 is the noised plan
    # the dispatch at round n copied out (eta = 0: the optimum)
    emitted = dict(agent.emitted)
    lagged = [np.array_equal(emitted[r + 1], host.numpy()[d:2 * d])
              for r, host in agent.dispatches if r + 1 in emitted]
    res["lag_checked"] = len(lagged)
    res["fill_round"] = {"explored": hist[xi].explored,
                         "pipelined": hist[xi].pipelined,
                         "runtime_s": hist[xi].runtime_s}
    res["collects"], res["collects_ready"] = agent.collects, \
        agent.collects_ready
    check(all(lagged) and len(lagged) >= len(hist) - xi - 1,
          f"pipeline: {lagged.count(False)} of {len(lagged)} plans not the "
          "previous dispatch's")
    check(hist[xi].pipelined and hist[xi].runtime_s == 0.0
          and all(not h.explored for h in hist[xi + 1:]),
          f"pipeline: the first solved cycle is no fill round {res['fill_round']}")
    check(agent.collects_ready >= 1,
          f"pipeline: no collect found its event complete ({agent.collects})")
    check(piped["trace"]["dtoh_copies"] is not None
          and piped["trace"]["dtoh_copies"] <= 1.0
          and not piped["syncs_in_one_decide"],
          f"pipeline: a pipelined decide copied {piped['trace']['dtoh_copies']}"
          f" times, syncs {piped['syncs_in_one_decide']}")
    # a topology change drops the pending result: a forced move, then an
    # arrival; each time the next cycle is a fill round
    drops = {}
    for change in ("move", "arrive"):
        env.run(agent, duration_s=10.0)
        check(agent._pending is not None, f"pipeline {change}: none pending")
        if change == "move":
            sid = env.platform.services()[0]
            src = env.platform.host_of(sid).host
            dst = next(h.host for h in env.platform.hosts() if h.host != src)
            env.platform.rebalance({sid: {src: 0.0, dst: 1e3}}, limit=1)
            agent._build_fleet_problem()
        else:
            env.apply_event(ChurnEvent(
                t=env.t, kind="arrive",
                profile=paper_profiles()["qr-detector"]), agent)
        dropped = agent._pending is None
        nxt = env.run(agent, duration_s=20.0)
        drops[change] = {"dropped": dropped,
                         "next": [(h.pipelined, h.explored, h.runtime_s > 0)
                                  for h in nxt]}
        check(dropped and nxt[0].runtime_s == 0.0 and not nxt[0].explored
              and nxt[1].runtime_s > 0.0,
              f"pipeline {change}: pending not dropped {drops[change]}")
    res["drops"] = drops
    log(json.dumps({k: v for k, v in res.items()
                    if k not in ("sync", "pipelined")}))
    return res


def _e10_patterns(kind, seconds, seed=0):
    from repro_torch.env import bursty, constant, diurnal
    fn = bursty if kind == "bursty" else diurnal
    return {"qr-detector": fn(100.0, duration_s=seconds, seed=seed),
            "cv-analyzer": fn(10.0, duration_s=seconds, seed=seed + 100),
            "pc-visualizer": constant(50.0)}


def _e10_run(dev, kind, forecast, cls=None, seconds=E10_SECONDS,
             events=(), **cfg):
    """e10's ``_run_mode``: the paper triple on 8 cores under e3's
    ``kind`` trace, ``RaskConfig(xi=12, eta=0.0, forecast=...)``, with
    ``events`` (churn); records the design-window uploads after every
    cycle."""
    from repro_torch.core import RASKAgent, RaskConfig
    from repro_torch.core.regression import TRACE_COUNTS
    from repro_torch.env import EdgeEnvironment, paper_knowledge, \
        paper_profiles
    env = EdgeEnvironment(list(paper_profiles().values()), {"cores": 8.0},
                          patterns=_e10_patterns(kind, seconds), seed=0)
    agent = (cls or RASKAgent)(
        env.platform, paper_knowledge(),
        RaskConfig(xi=E10_XI, eta=0.0, forecast=forecast, **cfg), seed=0,
        device=dev)
    uploads = []
    hist = env.run(agent, duration_s=seconds, events=list(events),
                   on_cycle=lambda rec: uploads.append(
                       TRACE_COUNTS["h2d_design_upload"]))
    return env, agent, hist, uploads


def _e10_row(hist, uploads):
    import numpy as np
    post = [h.fulfillment for h in hist if not h.explored]
    tail = uploads[-E10_QUIET:]
    used = [h.forecast_used for h in hist]
    return {"mean_fulfillment": float(np.mean(post)),
            "violations_0_9": float(np.mean([f < 0.9 for f in post])),
            "proactive_cycles": sum(1 for u in used if u),
            "worst_rolling_err": max((h.forecast_err for h in hist
                                      if h.forecast_used), default=0.0),
            "tail_uploads": tail[-1] - tail[0]}


def phase_forecast(dev):
    """e10's ``proactive_bench`` on the card: bursty and diurnal e3 traces,
    reactive then forecast, each against a CPU twin fed the card's
    uniforms."""
    from repro_torch.core import RASKAgent

    res = {"phase": "forecast", "seconds": E10_SECONDS, "xi": E10_XI}
    for kind in ("bursty", "diurnal"):
        out = {}
        for forecast in (False, True):
            mode = "forecast" if forecast else "reactive"
            cls = _dispatch_log(RASKAgent)
            torch.cuda.synchronize()
            _zero_rask_counts()
            with PlainOnCard() as plain:
                t0 = time.perf_counter()
                env, agent, hist, uploads = _e10_run(dev, kind, forecast, cls)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = _rask_counts()
            row = _e10_row(hist, uploads)
            row.update(wall_s=wall, launches={
                "rask_objective": launches[0],
                "rask_objective_grad": launches[1]},
                launches_expected=_expect_launches(agent),
                plain_calls_on_card=plain.calls,
                decide=_steady_ms(hist))
            check(launches == row["launches_expected"],
                  f"forecast {kind} {mode}: launches {launches}")
            check(not any(plain.calls.values()),
                  f"forecast {kind} {mode}: plain versions on the card")
            check(row["tail_uploads"] == 0,
                  f"forecast {kind} {mode}: {row['tail_uploads']} design "
                  "uploads in the quiet tail")
            obs = iter([agent.observe(env.t) for _ in range(4)])
            row["trace"] = profile_window(f"{kind}_{mode}_decide",
                                          lambda: agent.decide(next(obs)), 3)
            out[mode] = (row, hist)
        # the CPU twin of the forecast run, from the card's uniforms
        _, _, cpu_hist, _ = _e10_run(torch.device("cpu"), kind, True,
                                     _cuda_starts(RASKAgent, dev))
        row, hist = out["forecast"]
        react = out["reactive"][0]
        cpu_row = _e10_row(cpu_hist, [0] * len(cpu_hist))
        row["cpu"] = {k: cpu_row[k] for k in ("mean_fulfillment",
                                             "violations_0_9",
                                             "proactive_cycles")}
        row["fulfillment_gap_cpu"] = abs(row["mean_fulfillment"]
                                         - cpu_row["mean_fulfillment"])
        row["forecast_used_equal_cpu"] = [h.forecast_used for h in hist] \
            == [h.forecast_used for h in cpu_hist]
        row["added_launches_a_decide"] = row["trace"]["launches"] \
            - react["trace"]["launches"]
        row["added_busy_ms_a_decide"] = None if None in (
            row["trace"]["device_busy_ms"], react["trace"]["device_busy_ms"]) \
            else row["trace"]["device_busy_ms"] \
            - react["trace"]["device_busy_ms"]
        res[kind] = {"reactive": react, "forecast": row}
        log(json.dumps({kind: res[kind]}))
        check(row["forecast_used_equal_cpu"],
              f"forecast {kind}: forecast_used differs from the CPU twin's")
        check(row["fulfillment_gap_cpu"] <= 0.03,
              f"forecast {kind}: fulfillment {row['mean_fulfillment']} vs "
              f"{cpu_row['mean_fulfillment']} on the CPU")
        check(row["proactive_cycles"] > 0,
              f"forecast {kind}: the gate never opened")
        check(row["trace"]["dtoh_copies"] is not None
              and row["trace"]["dtoh_copies"] <= 1.0,
              f"forecast {kind}: {row['trace']['dtoh_copies']} copies a "
              "decide")
    return res


def phase_transfer(dev):
    """e10's ``transfer_bench`` on the card: the diurnal trace, a QR
    arrival at 400 s of 600, forecast on, with and without priors."""
    from repro_torch.core import RASKAgent
    from repro_torch.env import ChurnEvent, paper_profiles

    res = {"phase": "transfer", "seconds": TRANSFER_SECONDS,
           "arrive_t": TRANSFER_ARRIVE}
    _zero_rask_counts()
    cls = _dispatch_log(RASKAgent)
    expected = [0, 0]
    with PlainOnCard() as plain:
        for label, priors in (("with_priors", True),
                              ("without_priors", False)):
            ev = ChurnEvent(t=TRANSFER_ARRIVE, kind="arrive",
                            profile=paper_profiles()["qr-detector"])
            _, agent, hist, _ = _e10_run(
                dev, "diurnal", True, cls, seconds=TRANSFER_SECONDS,
                transfer_priors=priors, events=[ev])
            post = [h for h in hist if h.t > TRANSFER_ARRIVE]
            res[label] = {
                "post_arrival_cycles": len(post),
                "post_arrival_explored": sum(h.explored for h in post),
                "mean_post_fulfillment": float(statistics.mean(
                    h.fulfillment for h in post)),
                "services": len(agent.services)}
            f, b = _expect_launches(agent)
            expected[0] += f
            expected[1] += b
        torch.cuda.synchronize()
        launches = _rask_counts()
    res["launches"] = {"rask_objective": launches[0],
                       "rask_objective_grad": launches[1]}
    res["priors_skip_exploration"] = \
        res["with_priors"]["post_arrival_explored"] == 0 \
        and res["without_priors"]["post_arrival_explored"] > 0
    log(json.dumps(res))
    check(res["priors_skip_exploration"],
          f"transfer: {res['with_priors']} / {res['without_priors']}")
    check(launches == tuple(expected), f"transfer: launches {launches}, "
          f"want {expected}")
    check(not any(plain.calls.values()), "transfer: plain versions on card")
    return res


def phase_burn_budget(dev):
    """e9's ``burn_failover_bench`` on the card: the failover world with
    ``RaskConfig(xi=20, eta=0.0, rebalance_every=3, adapt_budget=True)``
    and the simulated SLO accountant; then the RASK kernels at the shrunk
    budget's shapes on that agent's tables and models."""
    import numpy as np

    from repro_torch.core import RASKAgent, RaskConfig
    from repro_torch.env import failover_scenario, sim_slo_budget
    from repro_torch.obs import SLOAccountant

    env, knowledge, events = failover_scenario(duration_s=E9_SECONDS, seed=0)
    agent = _dispatch_log(RASKAgent)(
        env.platform, knowledge,
        RaskConfig(xi=20, eta=0.0, rebalance_every=3, adapt_budget=True),
        seed=0, device=dev)
    acct = SLOAccountant(env.platform, sim_slo_budget())
    agent.attach_accountant(acct)
    fail_t = events[0].t
    levels = []
    torch.cuda.synchronize()
    _zero_rask_counts()
    with PlainOnCard() as plain:
        t0 = time.perf_counter()
        hist = env.run(agent, duration_s=E9_SECONDS, events=events,
                       on_cycle=lambda rec: levels.append(
                           (rec.t, rec.alerts, agent.last_decision.pgd_starts,
                            agent.last_decision.pgd_iters,
                            agent.last_decision.score_starts,
                            agent.last_decision.score_iters)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _rask_counts()
    fast = [(t, ev) for t, _, pol, ev in acct.alert_log if pol == "fast"]
    fires = [t for t, ev in fast if ev == "fire" and t > fail_t]
    clears = [t for t, ev in fast if ev == "clear" and t > fail_t]
    cfg = agent.cfg
    # a firing alert restores the full solve budget before the solve
    alert_levels = {(s, i) for _, a, s, i, _, _ in levels if a and s}
    pre = [h.fulfillment for h in hist if h.t <= fail_t and not h.explored]
    post = [h.fulfillment for h in hist if h.t > fail_t]
    settled = [h.fulfillment for h in hist if h.t > fail_t + 100.0]
    want = _expect_launches(agent)
    res = {"phase": "burn_budget", "seconds": E9_SECONDS, "fail_t": fail_t,
           "alert_fire_t": min(fires) if fires else None,
           "alert_clear_t": max(clears) if clears else None,
           "fast_alert_log": fast,
           "alert_cycles": sum(1 for h in hist if h.alerts),
           "alert_cycle_levels": sorted(alert_levels),
           "mean_pre_failover": float(np.mean(pre)),
           "min_post_failover": float(np.min(post)),
           "mean_recovered": float(np.mean(settled)),
           "moves": agent.moves_total, "wall_s": wall,
           "budget_levels": levels,
           "solve_levels": sorted({(s, i) for _, _, s, i, _, _ in levels
                                   if s}),
           "launches": {"rask_objective": launches[0],
                        "rask_objective_grad": launches[1]},
           "launches_expected": want, "plain_calls_on_card": plain.calls,
           "decide": _steady_ms(hist)}
    log(json.dumps({k: v for k, v in res.items() if k != "budget_levels"}))
    check(launches == want, f"burn_budget: launches {launches}, want {want}")
    check(not any(plain.calls.values()), "burn_budget: plain on the card")
    check(len(res["solve_levels"]) >= 2,
          f"burn_budget: the budget never moved {res['solve_levels']}")
    check(res["alert_cycles"] > 0
          and alert_levels == {(cfg.pgd_starts, cfg.pgd_iters)},
          f"burn_budget: alert cycles {res['alert_cycles']} solved at "
          f"{sorted(alert_levels)}, want the full budget")

    # the kernels at the shrunk budget's shapes, on this agent's tables
    rps_g = torch.from_numpy(agent._rps_vector(None)).to(dev)
    cases = []
    for K in (2, 3):
        cases += _rask_cases(agent, env.t, K, 40 + K, f"e9_K{K}")
    for bk in agent.fleet_problem.buckets:
        cases += _batched_cases(bk, agent.stacked, rps_g, 2,
                                f"e9_fleet_B{len(bk.hosts)}_K2")
    agent.placement_scores(agent.observe(env.t))
    for bk in agent.last_pp.buckets:
        cases += _batched_cases(bk, agent.stacked, rps_g, 2,
                                f"e9_placement_B{len(bk.hosts)}_K2")
    res["kernel_cases"] = cases
    # a decide's cost at the full and the floor budget (adaptation and the
    # placement stage paused, so each window holds one level)
    agent.cfg.adapt_budget, agent.cfg.rebalance_every = False, 0
    for starts, iters in ((agent.cfg.pgd_starts, agent.cfg.pgd_iters),
                          (agent.cfg.adapt_starts_floor,
                           agent.cfg.adapt_iters_floor)):
        agent._budget_starts, agent._budget_iters = starts, iters
        obs = iter([agent.observe(env.t) for _ in range(4)])
        res[f"trace_K{starts}_iters{iters}"] = profile_window(
            f"e9_decide_K{starts}_iters{iters}",
            lambda: agent.decide(next(obs)), 3)
    log(json.dumps({k: v for k, v in res.items() if k.startswith("trace")}))
    return res


# -- the paper's comparison: SLSQP, auto_degree, the baselines, metrics ---------

BACKENDS = (("pgd", {}), ("slsqp", {"backend": "slsqp"}),
            ("slsqp_loop", {"backend": "slsqp", "fused": False}))
BACKEND_SECONDS = 120.0
SOTA_SECONDS = 900.0            # e3 runs 1800 s, 2 reps
SOTA_TRAIN_SECONDS = 300.0      # e3's _trained_rask
SOTA_TOL = 0.03                 # the fulfilment bar of PRs 17-19
AUTO_SECONDS = 600.0


def _launch_counts():
    f, b = _rask_counts()
    return {"rask_objective": f, "rask_objective_grad": b}


def _train_rask(dev, replicas=1, seed=0, cls=None):
    """e3's ``_trained_rask``: RASK (xi 20, eta 0, PGD) on the default
    constant-load environment, ``SOTA_TRAIN_SECONDS``, on ``dev``."""
    from repro_torch.core import RASKAgent, RaskConfig
    from repro_torch.env import paper_knowledge
    env = _rask_env(replicas, seed=seed)
    agent = (cls or RASKAgent)(env.platform, paper_knowledge(),
                               RaskConfig(xi=20, eta=0.0), seed=seed,
                               device=dev)
    env.run(agent, duration_s=SOTA_TRAIN_SECONDS)
    return env, agent


def _transplant(trained, env, dev, cls, seed=0, **cfg):
    """e3's transplant: a fresh agent on ``env`` (xi 0, eta 0) takes a deep
    copy of the trained agent's table, its rounds and its warm start; its
    first decide rebuilds the fit from that table."""
    import copy

    from repro_torch.core import RaskConfig
    from repro_torch.env import paper_knowledge
    agent = cls(env.platform, paper_knowledge(),
                RaskConfig(xi=0, eta=0.0, **cfg), seed=seed, device=dev)
    agent.table = copy.deepcopy(trained["table"])
    agent.rounds = trained["rounds"]
    agent._cached_x = None if trained["x"] is None else trained["x"].copy()
    return agent


def _trained_state(agent):
    import copy
    return {"table": copy.deepcopy(agent.table), "rounds": agent.rounds,
            "x": None if agent._cached_x is None else agent._cached_x.copy()}


def _noting(cls):
    """``cls`` keeping each solve's SLSQP evaluations and the random-start
    uniforms it drew by seed (``starts``), or taking them from a table
    handed over (a twin on another device then starts from the same
    draws). It also keeps what a lockstep twin replays (``log``: each
    emitted plan vector, warm start, optimum and score); given such a
    ``replay`` log, it emits the logged plans and warm-starts from the
    logged optima, while solving for itself (its own plans and scores in
    ``log``)."""
    import numpy as np

    class Noted(cls):
        given = None
        replay = None

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.evals, self.starts = [], {}
            self.log = {"plans": [], "x0s": [], "cached": [], "scores": []}

        def decide(self, obs):
            plan = super().decide(obs)
            info = self.last_decision
            if not info.explored and self.cfg.backend == "slsqp":
                self.evals.append(self.problem.last_nfev)
            log = self.log
            log["scores"].append(None if info.explored else info.score)
            if self.replay is not None:
                self._cached_x = self.replay["cached"][
                    len(log["cached"])]
            log["cached"].append(None if self._cached_x is None
                                 else np.array(self._cached_x))
            return plan

        def _plan(self, a):
            log = self.log["plans"]
            log.append(np.array(a, np.float32))
            if self.replay is not None:
                a = self.replay["plans"][len(log) - 1]
            return super()._plan(a)

        def _x0(self):
            x = super()._x0()           # the same rng draws either way
            log = self.log["x0s"]
            log.append(np.array(x, np.float32))
            if self.replay is not None:
                x = self.replay["x0s"][len(log) - 1]
            return x

        def _start_uniforms(self, seed):
            if self.given is None:
                u = super()._start_uniforms(seed)
                self.starts[seed] = u.cpu().numpy()
                return u
            self._gen.manual_seed(seed)
            return torch.as_tensor(self.given[seed], device=self.device)
    return Noted


def phase_backends(dev):
    """e7's ``decide_slsqp``/``decide_loop`` and ``compare_solvers`` on the
    card: the paper triple with 1 and 3 replicas (|S| = 3, 9), each
    transplanted from a trained agent (e3's way) into a fresh agent of
    each backend, ``BACKEND_SECONDS`` at the default loads."""
    import numpy as np

    from repro_torch.core import RASKAgent
    from repro_torch.core.regression import StackedModels
    from repro_torch.core.solver import SolverProblem

    res, total = {"phase": "backends"}, dict.fromkeys(
        ("rask_objective", "rask_objective_grad"), 0)
    cpu = torch.device("cpu")
    for replicas in (1, 3):
        S = 3 * replicas
        tenv, trained = _train_rask(dev, replicas)
        state = _trained_state(trained)
        rows = {}
        for name, cfg in BACKENDS:
            env = _rask_env(replicas)
            agent = _transplant(state, env, dev, _noting(RASKAgent), **cfg)
            torch.cuda.synchronize()
            _zero_rask_counts()
            t0 = time.perf_counter()
            hist = env.run(agent, duration_s=BACKEND_SECONDS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launch_counts()
            n = sum(not h.explored for h in hist)
            check(n == len(hist), f"backends {name} S{S}: {n} solved of "
                  f"{len(hist)}")
            for k in total:
                total[k] += launches[k]
            syncs = _syncs_in(lambda: agent.decide(agent.observe(env.t)))
            sync_evals = agent.evals[-1] if agent.evals else None
            obs = iter([agent.observe(env.t) for _ in range(4)])
            window = profile_window(f"decide_{name}_S{S}",
                                    lambda: agent.decide(next(obs)), 2)
            post = float(np.mean([h.fulfillment for h in hist]))
            rows[name] = {
                "decide": _steady_ms(hist), "wall_s": wall,
                "launches": launches,
                "kernel_launches_per_decide": {k: v / n for k, v in
                                               launches.items()},
                "evals_per_solve": (statistics.median(agent.evals)
                                    if agent.evals else None),
                "evals_max": max(agent.evals) if agent.evals else None,
                "syncs_in_one_decide": len(syncs),
                "evals_in_that_decide": sync_evals,
                "sync_messages": syncs[:3], "profile": window,
                "fulfillment": post}
            log(f"backends S{S} {name}: {rows[name]['decide']} "
                f"syncs {len(syncs)} evals {sync_evals}")
            if name == "slsqp":
                # fused SLSQP: one device-to-host copy a scipy evaluation
                check(len(syncs) <= sync_evals + 1,
                      f"backends slsqp S{S}: {len(syncs)} syncs for "
                      f"{sync_evals} evaluations")
                check(launches["rask_objective"] == sum(agent.evals[:n]),
                      f"backends slsqp S{S}: {launches} for "
                      f"{sum(agent.evals[:n])} evaluations")
            if name == "pgd":
                check(launches["rask_objective"] == n and
                      launches["rask_objective_grad"] ==
                      agent.cfg.pgd_iters * n,
                      f"backends pgd S{S}: {launches} for {n} solves")

        # repro's parity bar on one warm-started problem, and the card's
        # SLSQP against its CPU twin from the same models and x0
        p, sm = trained.problem, trained.stacked
        rps = trained._rps_vector(trained.platform.window_states(
            tenv.t - 5.0, tenv.t))
        x0, cap = trained._cached_x, trained.capacity
        a_s, s_slsqp = p.solve_slsqp(sm, rps, x0, cap)
        evals = p.last_nfev
        _, s_pgd = p.solve_pgd(sm, rps, x0, cap, seed=0)
        twin = SolverProblem(p.specs, device=cpu)
        sm_cpu = StackedModels(sm.w.cpu(), sm.exponents.cpu(),
                               sm.term_mask.cpu(), sm.x_scale.cpu(),
                               sm.max_degree, sm.labels)
        _, s_cpu = twin.solve_slsqp(sm_cpu, rps, x0, cap)
        gate = {"score_pgd": s_pgd, "score_slsqp": s_slsqp,
                "slsqp_evals": evals, "score_slsqp_cpu": s_cpu,
                "slsqp_card_vs_cpu": abs(s_slsqp - s_cpu) / abs(s_cpu),
                "tolerance": 1e-4, "parity_bar": 0.05}
        rows["parity"] = gate
        log(f"backends S{S} parity: {gate}")
        check(s_pgd >= s_slsqp - 0.05 * abs(s_slsqp),
              f"backends S{S}: PGD {s_pgd} under SLSQP {s_slsqp} - 5%")
        check(gate["slsqp_card_vs_cpu"] <= 1e-4,
              f"backends S{S}: SLSQP card {s_slsqp} vs CPU {s_cpu}")
        res[f"S{S}"] = rows
    res["launches"] = total
    return res


def _selecting(cls):
    """``cls`` noting each ``select_degree`` call of its own (round,
    service, design rows, scale, pick, errors) in ``selections``, through
    a wrapper of ``core/rask.py``'s ``select_degree`` that lives while
    ``noting()`` is entered."""
    import contextlib

    from repro_torch.core import rask as rask_mod

    class Selecting(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.selections = {}

        def _degree(self, sid, X, Y, scale):
            self._noting_key = (self.rounds, sid)
            return super()._degree(sid, X, Y, scale)

        @contextlib.contextmanager
        def noting(self):
            inner = rask_mod.select_degree

            def select(X, Y, *args, **kwargs):
                best, errs = inner(X, Y, *args, **kwargs)
                self.selections[self._noting_key] = {
                    "X": X, "Y": Y, "scale": kwargs.get("x_scale"),
                    "best": best, "errs": errs}
                return best, errs
            rask_mod.select_degree = select
            try:
                yield
            finally:
                rask_mod.select_degree = inner
    return Selecting


def phase_auto_degree(dev):
    """RASK with ``auto_degree=True`` on the paper triple under e3's
    diurnal mix (8 cores, xi 20, ``AUTO_SECONDS``) on the card, beside the
    fixed degree 2; then ``select_degree`` on the card against the CPU on
    the agent's own last selection of each service."""
    import numpy as np

    from repro_torch.core import RASKAgent, RaskConfig
    from repro_torch.core.regression import select_degree
    from repro_torch.env import paper_knowledge

    res, agents = {"phase": "auto_degree"}, {}
    for mode in ("auto", "fixed"):
        env = _rask_env(1, _e3_mix())
        agent = _selecting(RASKAgent)(
            env.platform, paper_knowledge(),
            RaskConfig(xi=20, auto_degree=(mode == "auto")), seed=0,
            device=dev)
        torch.cuda.synchronize()
        _zero_rask_counts()
        with agent.noting():
            hist = env.run(agent, duration_s=AUTO_SECONDS)
        torch.cuda.synchronize()
        launches = _launch_counts()
        agents[mode] = (env, agent)
        n = sum(not h.explored for h in hist)
        check(launches["rask_objective"] == n and
              launches["rask_objective_grad"] == agent.cfg.pgd_iters * n,
              f"auto_degree {mode}: {launches} for {n} solves")
        row = {"launches": launches, "solved": n,
               "post_explore_fulfillment": float(np.mean(
                   [h.fulfillment for h in hist if not h.explored])),
               "decide": _steady_ms(hist),
               "degrees_fitted": list(agent._fit_plan_key[1])}
        if mode == "auto":
            row["selections"] = [
                {"round": r, "sid": s, "best": x["best"],
                 "errs": x["errs"], "rows": len(x["Y"])}
                for (r, s), x in sorted(agent.selections.items())]
            rounds = {r for r, _ in agent.selections}
            on = [1e3 * h.runtime_s for i, h in enumerate(hist)
                  if not h.explored and i in rounds]
            off = [1e3 * h.runtime_s for i, h in enumerate(hist)
                   if not h.explored and i not in rounds][1:]
            row.update(selection_rounds=sorted(rounds),
                       decide_ms_selection_cycles=on,
                       decide_ms_median_selection=statistics.median(on)
                       if on else None,
                       decide_ms_median_other=statistics.median(off))
        else:
            check(not agent.selections, "auto_degree fixed: a selection ran")
        res[mode] = row
        log(f"auto_degree {mode}: {row}")

    # the card's select_degree against the CPU's on the agent's own table
    env, agent = agents["auto"]
    check(agent.selections, "auto_degree: no selection ran")
    last = {sid: x for (_, sid), x in sorted(agent.selections.items())}
    cmp = {}
    for sid, x in last.items():
        best, errs = select_degree(x["X"], x["Y"], x_scale=x["scale"],
                                   device=dev)
        best_c, errs_c = select_degree(x["X"], x["Y"], x_scale=x["scale"])
        srt = sorted(errs_c.values())
        tied = (srt[1] - srt[0]) <= 0.01 * srt[0]
        gap = max(abs(errs[d] - errs_c[d]) / max(abs(errs_c[d]), 1e-30)
                  for d in errs)
        cmp[sid] = {"card": best, "cpu": best_c, "errs_rel_gap": gap,
                    "best_two_within_1pct": tied, "agent": x["best"]}
        check(best == best_c or tied,
              f"auto_degree {sid}: card picks {best}, CPU {best_c}")
        check(tied or gap <= 1e-4,
              f"auto_degree {sid}: errs apart by {gap}")
    res["card_vs_cpu"] = cmp
    res["fulfillment_gain_vs_fixed"] = \
        res["auto"]["post_explore_fulfillment"] - \
        res["fixed"]["post_explore_fulfillment"]
    res["launches"] = {k: res["auto"]["launches"][k]
                       + res["fixed"]["launches"][k]
                       for k in res["auto"]["launches"]}
    log(json.dumps({"auto_degree_card_vs_cpu": cmp}))
    return res, agents["auto"]


def _refit(agent, degrees):
    """A shallow copy of ``agent`` whose stacked models are refitted on its
    own training table at ``degrees`` (one a relation)."""
    import copy

    from repro_torch.core.regression import BatchedFitPlan, pad_capacity
    data = [agent.table.design_matrix(sid, f, target)
            for sid, target, f, _ in agent._rel_static]
    plan = BatchedFitPlan(
        [dict(n_features=len(f), degree=d, x_scale=scale)
         for (_, _, f, scale), d in zip(agent._rel_static, degrees)],
        pad_capacity(max(len(Y) for _, Y in data)), ridge=agent.cfg.ridge,
        device=agent.device)
    twin = copy.copy(agent)
    twin.stacked = plan.fit(data)
    return twin


def phase_rask_kernels_k1(dev, agents, auto):
    """Both RASK kernels at one candidate (K = 1, B = 1: an SLSQP
    evaluation) on the |S| = 3 and 9 agents of "decide_timing", and at the
    auto-degree tables: the |S| = 9 agent refitted at mixed degrees 1-6
    (cv-analyzer at 6: T = 84) and the "auto_degree" agent's own, at K = 1
    and 6; each against its plain version at ``RASK_TOL`` and timed."""
    from repro_torch.kernels.rask_objective import empty_launch_cuda

    rows = []
    for S in (3, 9):
        env, agent = agents[S]
        rows += _rask_cases(agent, env.t, 1, 100 + S, f"S{S}_K1")
    env, agent = agents[9]
    low = iter([1, 2, 3, 4, 5, 1, 2, 3, 4])
    degrees = [6 if agent._sid_types[sid] == "cv-analyzer" else next(low)
               for sid, *_ in agent._rel_static]
    mixed = _refit(agent, degrees)
    check(mixed.stacked.w.shape[1] == 84 and sorted(set(degrees)) ==
          [1, 2, 3, 4, 5, 6], f"rask_kernels_k1: tables {degrees}")
    aenv, aagent = auto
    for case, (e, a) in (("T84", (env, mixed)), ("auto", (aenv, aagent))):
        for K in (1, 6):
            new = _rask_cases(a, e.t, K, 200 + K, f"{case}_K{K}",
                              cancellation=True)
            for r in new:
                r["degrees"] = [lab[3] for lab in a.stacked.labels]
            rows += new
    empty_ms, _ = time_ms([lambda: empty_launch_cuda(dev)], 200)
    for row in rows:
        row["ms_over_empty_launch"] = row["ms"] / empty_ms
    res = {"phase": "rask_kernels_k1", "cases": rows,
           "empty_launch_ms": empty_ms}
    log(json.dumps({"rask_kernels_k1": [
        (r["kernel"], r["case"], r["ms"], r["max_abs_err"]) for r in rows]}))
    return res


def _sota_metrics(hist):
    """e3's per-run figures: the fulfilment curve and the relative load of
    the service with the widest load range (``benchmarks/common.py::
    run_agent``), then mean, peak (load >= 0.4) and low fulfilment and
    the violation rates at 0.8/0.9/0.95/1.0."""
    import numpy as np
    f = np.asarray([h.fulfillment for h in hist])
    keys = list(hist[0].rps)
    span = {k: max(h.rps[k] for h in hist) - min(h.rps[k] for h in hist)
            for k in keys}
    ref = max(span, key=span.get)
    top = max(h.rps[ref] for h in hist)
    load = np.asarray([h.rps[ref] / max(top, 1e-9) for h in hist])
    peak = load >= 0.4
    return {"mean_fulfillment": float(f.mean()),
            "peak_fulfillment": float(f[peak].mean()),
            "low_fulfillment": float(f[~peak].mean()),
            "violations": {str(t): float(np.mean(f < t))
                           for t in (0.8, 0.9, 0.95, 1.0)},
            "violations_peak": {str(t): float(np.mean(f[peak] < t))
                                for t in (0.8, 0.9, 0.95, 1.0)},
            "fulfillment_in_0_1": bool(np.all((f >= 0.0) & (f <= 1.0))),
            "cycles": len(f)}


def _sota_run(kind, name, dev, state, starts=None, dqn=None, replay=None):
    """One e3 run of agent ``name`` on ``dev`` under ``kind``: the RASK
    agents transplanted from ``state`` (``starts``: the random starts to
    take, else drawn and noted; ``replay``: a card run's log to replay in
    lockstep), the VPA, or the DQN whose pretrained networks ``dqn`` are
    deep-copied in. Returns (metrics, per-cycle
    (fulfilment, applied) pairs, the agent's starts, env, agent, wall s)."""
    import copy

    from repro_torch.core import RASKAgent
    from repro_torch.core.agents import DQNAgent, DQNConfig, VPAAgent
    env = _rask_env(1, _e10_patterns(kind, SOTA_SECONDS))
    if name in ("rask", "rask_pgd"):
        cls = _noting(RASKAgent)
        cls.given, cls.replay = starts, replay
        agent = _transplant(state, env, dev, cls,
                            backend="slsqp" if name == "rask" else "pgd")
    elif name == "vpa":
        agent = VPAAgent(env.platform)
    else:
        agent = DQNAgent(env.platform, DQNConfig(train_steps=1500), seed=0,
                         device=dev)
        agent.nets = copy.deepcopy(dqn)
    t0 = time.perf_counter()
    hist = env.run(agent, duration_s=SOTA_SECONDS)
    wall = time.perf_counter() - t0
    cycles = [(h.fulfillment, h.receipt.applied()) for h in hist]
    return (_sota_metrics(hist), cycles, getattr(agent, "starts", None),
            env, agent, wall)


def _dqn_pretrained(dev, models, rps, feats):
    """e3's DQN (``train_steps=1500``, seed 0) pretrained on ``dev`` on the
    trained RASK's tp_max surfaces; returns (agent, wall s)."""
    from repro_torch.core.agents import DQNAgent, DQNConfig
    from repro_torch.core.regression import PolynomialModel
    env = _rask_env(1)
    agent = DQNAgent(env.platform, DQNConfig(train_steps=1500), seed=0,
                     device=dev)
    models = {s: PolynomialModel(torch.as_tensor(w, device=dev), e, sc, d)
              for s, (w, e, sc, d) in models.items()}
    t0 = time.perf_counter()
    losses = agent.pretrain(models, rps, feats)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return agent, time.perf_counter() - t0, losses


def _sota_twin(kind, name, state, starts, dqn_inputs, replay=None):
    """A CPU twin of one e3 run, in a child process that never touches the
    card (``name == "dqn"``: pretrains on the CPU first, then runs both
    traces). With ``replay`` (the card run's ``log``) a lockstep twin runs
    too and its solve scores come back."""
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    if name == "dqn":
        agent, wall, losses = _dqn_pretrained(cpu, *dqn_inputs)
        return {k: _sota_run(k, "dqn", cpu, None, dqn=agent.nets)[0]
                for k in ("bursty", "diurnal")} | {
                    "pretrain_wall_s": wall, "losses": losses}
    metrics, cycles, _, _, agent, _ = _sota_run(kind, name, cpu, state,
                                                starts)
    out = {"metrics": metrics, "cycles": cycles}
    if replay is not None:
        lock = _sota_run(kind, name, cpu, state, starts, replay=replay)[4]
        out["lockstep_scores"] = lock.log["scores"]
    return out


def phase_sota(dev):
    """e3 cut to one rep of ``SOTA_SECONDS`` a trace: RASK (SLSQP) and
    RASK (PGD), each transplanted from one trained run (a deep copy of its
    table, rounds and warm start), the VPA and the DQN (pretrained once on
    the trained RASK's surfaces, 1500 steps), under e3's bursty and
    diurnal traces on the card; each run's CPU twin runs in a child
    process beside the card's runs."""
    import multiprocessing

    import numpy as np

    from repro_torch.env import paper_knowledge

    res = {"phase": "sota", "seconds": SOTA_SECONDS, "reps": 1}
    tenv, trained = _train_rask(dev)
    state = _trained_state(trained)
    sids = trained.services
    models = {s: (m["tp_max"].w.cpu().numpy(), m["tp_max"].exponents,
                  m["tp_max"].x_scale, m["tp_max"].degree)
              for s, m in trained.models.items()}
    feats = {s: tuple(paper_knowledge()[trained.platform.service(s).sid.type]
                      ["tp_max"]) for s in sids}
    rps = {s: trained.platform.service(s).backend.profile.default_rps
           for s in sids}
    dqn_inputs = (models, rps, feats)
    launches = dict.fromkeys(("rask_objective", "rask_objective_grad"), 0)
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        jobs = {("both", "dqn"): pool.apply_async(
            _sota_twin, (None, "dqn", None, None, dqn_inputs))}
        for kind in ("bursty", "diurnal"):
            jobs[(kind, "vpa")] = pool.apply_async(
                _sota_twin, (kind, "vpa", state, None, None))
        dqn, dqn_wall, dqn_losses = _dqn_pretrained(dev, *dqn_inputs)
        net = next(iter(dqn.nets.values()))
        g = torch.Generator(dev).manual_seed(0)
        B, n = dqn.cfg.batch_size, net.state_dim
        batch = (torch.rand((B, n), generator=g, device=dev),
                 torch.zeros(B, dtype=torch.int64, device=dev),
                 torch.rand(B, generator=g, device=dev),
                 torch.rand((B, n), generator=g, device=dev),
                 torch.zeros(B, device=dev))
        td_launches, _ = kernels_per_call(
            lambda: net.td_step(*batch, dqn.cfg.lr))
        res["dqn_pretrain"] = {"wall_s": dqn_wall, "losses": dqn_losses,
                               "td_step_launch_calls": td_launches}
        card, keep, card_scores = {}, {}, {}
        for kind in ("bursty", "diurnal"):
            for name in ("rask", "rask_pgd", "vpa", "dqn"):
                torch.cuda.synchronize()
                _zero_rask_counts()
                metrics, cycles, starts, env, agent, wall = _sota_run(
                    kind, name, dev, state, dqn=dqn.nets)
                torch.cuda.synchronize()
                got = _launch_counts()
                for k in launches:
                    launches[k] += got[k]
                metrics.update(wall_s=wall, launches=got)
                if name == "rask_pgd":
                    jobs[(kind, name)] = pool.apply_async(
                        _sota_twin, (kind, name, state, starts, None))
                if name == "rask":
                    jobs[(kind, name)] = pool.apply_async(
                        _sota_twin, (kind, name, state, None, None,
                                     agent.log))
                card[(kind, name)] = (metrics, cycles)
                if name == "rask":
                    keep[kind] = (env, agent)
                    card_scores[kind] = agent.log["scores"]
                log(f"sota {kind} {name}: {metrics}")
        cpu = {key: job.get(timeout=900) for key, job in jobs.items()}
    for kind in ("bursty", "diurnal"):
        per = {}
        for name in ("rask", "rask_pgd", "vpa", "dqn"):
            metrics, cycles = card[(kind, name)]
            twin = cpu[("both", "dqn")][kind] if name == "dqn" \
                else cpu[(kind, name)]["metrics"]
            metrics["cpu"] = twin
            metrics["gap_to_cpu"] = abs(metrics["mean_fulfillment"]
                                        - twin["mean_fulfillment"])
            check(metrics["fulfillment_in_0_1"] and metrics["cycles"] ==
                  int(SOTA_SECONDS / 10), f"sota {kind} {name}: {metrics}")
            if name == "vpa":
                same = cycles == cpu[(kind, name)]["cycles"]
                metrics["equals_cpu_cycle_by_cycle"] = same
                check(same, f"sota {kind} vpa: the card's cycles differ "
                      "from the CPU's")
            if name == "rask_pgd":
                check(metrics["gap_to_cpu"] <= SOTA_TOL,
                      f"sota {kind} {name}: {metrics['mean_fulfillment']} "
                      f"on the card vs {twin['mean_fulfillment']} on CPU")
            if name == "rask":
                # SLSQP is one local search warm-started from the last
                # optimum: free-running, a float32 rounding apart sends a
                # solve to another local optimum and the warm start keeps
                # the run there, so the twin is held in lockstep (it
                # emits the card's plans and warm starts from the card's
                # optima) and the solves are compared from the same inputs
                lock = np.asarray([(c, p) for c, p in zip(
                    card_scores[kind], cpu[(kind, name)]["lockstep_scores"],
                    strict=True) if c is not None], np.float64)
                gaps = np.abs(lock[:, 0] - lock[:, 1]) / np.abs(lock[:, 1])
                metrics["lockstep"] = {
                    "solves": len(gaps), "median_gap": float(np.median(gaps)),
                    "max_gap": float(gaps.max()),
                    "share_within_1e-3": float(np.mean(gaps <= 1e-3)),
                    "first_over_1e-3": int(np.argmax(gaps > 1e-3))
                    if (gaps > 1e-3).any() else None}
                check(np.median(gaps) <= 1e-4 and np.mean(gaps <= 1e-3)
                      >= 0.9, f"sota {kind} rask: lockstep solves apart "
                      f"{metrics['lockstep']}")
            per[name] = metrics
        best_base = min(per["vpa"]["violations_peak"]["0.9"],
                        per["dqn"]["violations_peak"]["0.9"])
        rask_v = min(per["rask"]["violations_peak"]["0.9"],
                     per["rask_pgd"]["violations_peak"]["0.9"])
        per["violation_reduction_vs_best_baseline"] = \
            float(1.0 - rask_v / best_base) if best_base > 0 else 0.0
        res[kind] = per
    res["dqn_pretrain"]["cpu_wall_s"] = cpu[("both", "dqn")][
        "pretrain_wall_s"]
    res["launches"] = launches
    res["paper_claim"] = "28% fewer SLO violations at high load (reported, " \
        "not gated)"
    return res, keep["diurnal"]


def phase_metrics(dev, env, agent):
    """``golden_signals`` over the "sota" RASK agent (the diurnal run, its
    decide on the card) with an ``SLOAccountant`` attached for 60 more
    seconds; then ``snapshot``, and one GET of ``MetricsServer`` (port 0)
    over loopback."""
    import urllib.request

    from repro_torch import obs
    from repro_torch.env import sim_slo_budget

    acct = obs.SLOAccountant(env.platform, sim_slo_budget())
    agent.attach_accountant(acct)
    env.run(agent, duration_s=60.0)
    reg = obs.MetricRegistry()
    obs.golden_signals(reg, env.platform, accountant=acct, agent=agent)
    text = obs.snapshot(reg)
    with obs.MetricsServer(reg, port=0) as srv:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics",
                                    timeout=30) as r:
            body = r.read().decode()
    families = sorted({line.split(" ")[2] for line in text.splitlines()
                       if line.startswith("# TYPE ")})
    res = {"phase": "metrics", "families": families,
           "lines": len(text.splitlines()), "bytes": len(text),
           "get_equals_render": body == text,
           "decide_lines": [line for line in text.splitlines()
                            if line.startswith("repro_decide")]}
    log(json.dumps(res))
    for family in ("repro_slo_budget_consumed", "repro_service_fulfillment",
                   "repro_decide_us", "repro_decide_score",
                   "repro_decide_pgd_iters"):
        check(family in families, f"metrics: {family} missing")
    check(body == text, "metrics: the GET differs from render")
    return res


# -- qwen2-moe-a2.7b, the control plane's CLI and the fleet launchers -------------

MOE_ARCH = "qwen2-moe-a2.7b"


class RouteCounts(FiniteLogits):
    """``FiniteLogits`` that also counts, for every prefill, the routes its
    MoE layers dropped at capacity (``models/moe.py::recording_routes``):
    those of real tokens (positions < length) by choice, and those of pads,
    by bucket width, as device counters read once at the end."""

    def __init__(self, model):
        super().__init__(model)
        self.drops = {}        # width -> [prompts, real tokens, real (k,), pad]

    def prefill(self, params, batch, max_seq, length=None):
        from repro_torch.models.moe import recording_routes
        B, width = batch["tokens"].shape
        check(B == 1, "route counts assume one prompt a prefill")
        n = width if length is None else int(length)
        with recording_routes() as routes:
            out = super().prefill(params, batch, max_seq=max_seq,
                                  length=length)
        dropped = torch.stack([~keep for _, keep in routes])   # (L, T, k)
        acc = self.drops.setdefault(width, [0, 0, 0, 0])
        acc[0] += 1
        acc[1] += n
        acc[2] = acc[2] + dropped[:, :n].sum(dim=(0, 1))
        acc[3] = acc[3] + dropped[:, n:].sum()
        return out


def phase_moe_serve(dev):
    """qwen2-moe-a2.7b at full width in bf16 (24 layers, d_model 2048, 16
    heads on 16 kv heads, d_head 128, 60 experts top-4 and 4 shared, vocab
    151936), weights from the card's seeded generator, behind phase
    "serve"'s engine and requests; the routes dropped at capacity by
    bucket. Earlier phases' models are gone: the memory left resident is
    reported, and the peak is this phase's own."""
    resident = _free_card()
    res, engine = phase_serve(dev, MOE_ARCH, "moe_serve", RouteCounts)
    res.update({"resident_gb_before": resident,
                "routes_dropped": _route_drops(engine.model,
                                               engine.model.cfg.n_layers)})
    log(json.dumps(res))
    return res, engine


def _free_card():
    """Collect the earlier phases' tensors and start this phase's peak;
    returns the GB still allocated."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    return resident


def _route_drops(model, moe_layers):
    """A ``RouteCounts`` model's drops by prompt width, over its
    ``moe_layers`` MoE layers."""
    k, drops = model.cfg.top_k, {}
    for width, (prompts, tokens, real, pad) in sorted(model.drops.items()):
        real = real.tolist()
        routes = tokens * k * moe_layers
        drops[str(width)] = {
            "prompts": prompts, "real_routes": routes,
            "real_routes_dropped": sum(real), "real_dropped_by_choice": real,
            "pad_routes_dropped": int(pad),
            "real_dropped_share": sum(real) / routes}
    return drops


def phase_moe_trace(engine):
    """``phase_trace`` on the MoE engine, beside the byte bound of a decode
    step: every layer's weights (all 60 experts, as the dense dispatch
    multiplies them), the vocab head and the KV slots the 4 rows attend to
    at the window's last step, over 3.35 TB/s."""
    res = phase_trace(engine, name="moe_trace")
    p, cfg = engine.params, engine.cfg
    mcfg = engine.model.cfg

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in _leaves(tree))
    layers = p["layers"]
    parts = {"experts": sum(nbytes({k: lp["ffn"][k] for k in
                                    ("up", "gate", "down")})
                            for lp in layers),
             "shared_expert": sum(nbytes(lp["ffn"]["shared"])
                                  for lp in layers),
             "router": sum(nbytes(lp["ffn"]["router"]) for lp in layers),
             "attention": sum(nbytes(lp["attn"]) for lp in layers),
             "norms": sum(nbytes([lp["ln1"], lp["ln2"]]) for lp in layers),
             "head": nbytes(p.get("head", p["embed"]))}
    live = torch.clamp(engine._cache["pos"], max=cfg.max_seq)
    parts["kv_read"] = int(live.sum()) * mcfg.n_layers * 2 \
        * mcfg.n_kv_heads * mcfg.d_head * 2
    step_bytes = sum(parts.values())
    busy = res["decode_step"]["device_busy_ms"]
    res.update({"step_bytes": parts, "step_bytes_total": step_bytes,
                "step_bound_ms": 1e3 * step_bytes / HBM_BYTES_PER_S,
                "busy_over_bound": not_measured(
                    busy, 1e3 * step_bytes / HBM_BYTES_PER_S)})
    log(json.dumps(res))
    return res


def phase_moe_crosscheck(dev):
    """qwen2-moe-a2.7b at full width cut to 2 layers, float32: a 300-token
    prompt right-padded to the 512 bucket (one routing group, cap 42) and
    4 decode steps on the card against the same weights on the CPU. The
    routes each MoE call kept must be the CPU's, bit for bit."""
    import gc

    import numpy as np

    from repro_torch.configs import get
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     reset_launches)
    from repro_torch.models import build
    from repro_torch.models.moe import recording_routes

    tol = 1e-3                      # phase "crosscheck"'s bar, same reason
    cfg = dataclasses.replace(get(MOE_ARCH), n_layers=2, dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator(dev).manual_seed(1))
    cpu_params = _to_cpu(params)
    n, width = 300, 512
    toks = np.zeros((1, width), np.int64)
    toks[0, :n] = np.random.default_rng(3).integers(0, cfg.vocab, n)
    toks = torch.from_numpy(toks)

    def routed(fn):
        with recording_routes() as routes:
            out = fn()
        return out, [(i.cpu(), k.cpu()) for i, k in routes]
    reset_launches()
    decode_attention_cuda.launches = 0
    (gl, gc_), g_routes = routed(lambda: model.prefill(
        params, {"tokens": toks.to(dev)}, max_seq=1024, length=n))
    flash = dict(flash_attention_cuda.variant_launches)
    (cl, cc), c_routes = routed(lambda: model.prefill(
        cpu_params, {"tokens": toks}, max_seq=1024, length=n))
    errs = [(gl.cpu() - cl).abs().max().item()]
    same = [int(gl.argmax()) == int(cl.argmax())]
    for _ in range(4):
        nxt = cl.argmax(-1)[:, None]
        (gl, gc_), r = routed(lambda: model.decode(params, nxt.to(dev), gc_))
        g_routes += r
        (cl, cc), r = routed(lambda: model.decode(cpu_params, nxt, cc))
        c_routes += r
        errs.append((gl.cpu() - cl).abs().max().item())
        same.append(int(gl.argmax()) == int(cl.argmax()))
    decode_launches = decode_attention_cuda.launches
    same_routes = len(g_routes) == len(c_routes) and all(
        torch.equal(gi, ci) and torch.equal(gk, ck)
        for (gi, gk), (ci, ck) in zip(g_routes, c_routes))
    prefill_keep = torch.stack([k for _, k in c_routes[:cfg.n_layers]])
    res = {"phase": "moe_crosscheck", "layers": cfg.n_layers, "prompt": n,
           "bucket": width, "decode_steps": 4, "max_abs_err": max(errs),
           "per_step_err": errs, "tolerance": tol, "argmax_agree": all(same),
           "routes_identical": same_routes,
           "prefill_real_routes_dropped": int((~prefill_keep[:, :n]).sum()),
           "prefill_pad_routes_dropped": int((~prefill_keep[:, n:]).sum()),
           "flash_launches": flash, "decode_launches": decode_launches}
    log(json.dumps(res))
    del params, cpu_params, gc_, cc
    gc.collect()
    torch.cuda.empty_cache()
    check(flash == {"wgmma": 0, "tf32x3": cfg.n_layers},
          f"moe cross-check: float32 prefill flash launches {flash}")
    check(decode_launches == 4 * cfg.n_layers,
          f"moe cross-check: {decode_launches} decode launches")
    check(same_routes, "moe cross-check: the card kept other routes")
    check(max(errs) <= tol, f"moe cross-check: logits differ by {max(errs)}")
    check(all(same), "moe cross-check: argmax tokens differ")
    return res


def _cli(main, argv):
    """``main(argv)``'s return value, its standard output as lines, and its
    wall seconds."""
    import contextlib
    import io
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue().splitlines(), time.perf_counter() - t


def _requested(rec):
    return sorted((o.sid, o.param, o.requested) for o in rec.receipt.outcomes)


def phase_autoscale_cli(dev):
    """``launch/autoscale.py`` on the card and with ``--device cpu``: the
    default (10 simulated minutes, diurnal, 3 LM services on 16 chips),
    then 9 services on 3 hosts with the placement stage every 3 cycles,
    the SLO accountant and a metrics dump. The exploration plans (the first
    xi = 20 cycles, numpy draws projected on the host) must be the CPU's
    exactly, the dumps must hold the same metric families, every
    fulfilment must lie in [0, 1], and the card's decides must have gone
    through the RASK kernels."""
    import re
    import tempfile

    from repro_torch.launch import autoscale

    res = {"phase": "autoscale_cli"}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in (("default", []),
                           ("fleet", ["--hosts", "3", "--replicas", "3",
                                      "--rebalance-every", "3", "--slo-burn",
                                      "--dump-metrics", f"{tmp}/{{}}.prom"])):
            runs = {}
            for side in ("cuda", "cpu"):
                _zero_rask_counts()
                hist, lines, wall = _cli(autoscale.main, [
                    a.format(side) for a in argv] + ["--device", side])
                runs[side] = hist
                solved = sum(not h.explored for h in hist)
                res[f"{name}_{side}"] = {
                    "summary": lines, "wall_s": wall, "cycles": len(hist),
                    "solved": solved,
                    "post_fulfillment": statistics.mean(
                        h.fulfillment for h in hist if not h.explored),
                    "launches": _launch_counts()}
                check(all(0.0 <= h.fulfillment <= 1.0 for h in hist),
                      f"autoscale_cli {name} {side}: fulfilment out of "
                      "[0, 1]")
            card, cpu = runs["cuda"], runs["cpu"]
            explored = [(h, c) for h, c in zip(card, cpu) if h.explored]
            res[f"{name}_explore_identical"] = len(card) == len(cpu) and \
                [h.explored for h in card] == [c.explored for c in cpu] and \
                all(_requested(h) == _requested(c) for h, c in explored)
            launches = res[f"{name}_cuda"]["launches"]
            solved = res[f"{name}_cuda"]["solved"]
            check(res[f"{name}_explore_identical"] and len(explored) == 20,
                  f"autoscale_cli {name}: exploration plans differ")
            check(launches["rask_objective"] >= solved and
                  launches["rask_objective_grad"] >= 32 * solved > 0,
                  f"autoscale_cli {name}: {launches} RASK launches for "
                  f"{solved} solved decides")
        fams = [sorted(re.findall(r"^# TYPE (\S+) ",
                                  Path(f"{tmp}/{side}.prom").read_text(),
                                  re.M)) for side in ("cuda", "cpu")]
    res["metric_families"] = len(fams[0])
    log(json.dumps(res))
    check(fams[0] == fams[1] and "repro_slo_budget_consumed" in fams[0],
          "autoscale_cli: the card's metric families differ")
    return res


def phase_fleet_launchers(dev):
    """``launch/fleet_autoscale.py`` (9 services on 3 hosts of 8 cores, 600
    s) and ``launch/hetero_fleet.py`` (camera/hub/gateway, 900 s, then a
    rebalance) on the card: both end, every host inside its budget, their
    decides through the RASK kernels."""
    import re

    from repro_torch.launch import fleet_autoscale, hetero_fleet

    res = {"phase": "fleet_launchers"}
    for name, main in (("fleet_autoscale", fleet_autoscale.main),
                       ("hetero_fleet", hetero_fleet.main)):
        _zero_rask_counts()
        rc, lines, wall = _cli(main, ["--device", "cuda"])
        launches = _launch_counts()
        res[name] = {"output": lines, "wall_s": wall, "launches": launches}
        check(rc == 0, f"{name}: exit {rc}")
        check(launches["rask_objective"] > 0
              and launches["rask_objective_grad"] > 0,
              f"{name}: no RASK launch ({launches})")
        for used, cap in re.findall(r": ([\d.]+)/([\d.]+) cores", "\n".join(
                lines)):
            check(float(used) <= float(cap) + 1e-6,
                  f"{name}: {used} of {cap} cores")
        fulfil = [float(x) for x in re.findall(
            r"post-exploration mean fulfillment: ([\d.]+)", "\n".join(lines))]
        check(len(fulfil) == 1 and 0.0 <= fulfil[0] <= 1.0,
              f"{name}: no fulfilment line")
    log(json.dumps(res))
    return res


# -- whisper-large-v3, gemma3-1b's mixed cache and jamba ----------------------

WHISPER_ARCH = "whisper-large-v3"
WHISPER_CLIPS, WHISPER_FRAMES, WHISPER_PROMPT = 4, 1500, 4
WHISPER_STEPS = 64               # decode steps after the prompt
JAMBA_ARCH = "jamba-1.5-large-398b"


def _attention_launches():
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    return {"decode_attention": decode_attention_cuda.launches,
            **{f"flash_{v}": n for v, n in
               flash_attention_cuda.variant_launches.items()}}


def _zero_attention_launches():
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import reset_launches
    decode_attention_cuda.launches = 0
    reset_launches()


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _whisper_inputs(cfg, dev, clips, seed):
    """``clips`` clips of 1,500 seeded frame embeddings (30 s of audio after
    the stub frontend) and a seeded prompt of 4 tokens, on ``dev``."""
    g = torch.Generator(dev).manual_seed(seed)
    frames = torch.randn((clips, WHISPER_FRAMES, cfg.d_model), generator=g,
                         device=dev).to(getattr(torch, cfg.dtype))
    tokens = torch.randint(0, cfg.vocab, (clips, WHISPER_PROMPT),
                           generator=g, device=dev)
    return {"frames": frames, "tokens": tokens}


def phase_encdec_crosscheck(dev):
    """whisper-large-v3 at full width (d_model 1280, 20 heads on 20 kv
    heads, d_head 64, vocab 51866) cut to 2 encoder and 2 decoder layers,
    float32: one clip of 1,500 frames, a 4-token prompt and 4 decode steps
    on the card against the same weights on the CPU. The prefill must
    launch the float32 flash kernel once an encoder layer (not causal) and
    twice a decoder layer (the causal prompt and its cross-attention), a
    decode step the decode kernel twice a decoder layer (self and cross)."""
    from repro_torch.configs import get
    from repro_torch.models import build

    tol = 1e-3                      # phase "crosscheck"'s bar, same reason
    cfg = dataclasses.replace(get(WHISPER_ARCH), n_layers=2,
                              encoder_layers=2, dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator(dev).manual_seed(2))
    cpu_params = _to_cpu(params)
    batch = _whisper_inputs(cfg, dev, 1, seed=5)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    _zero_attention_launches()
    gl, gc_ = model.prefill(params, batch, max_seq=WHISPER_FRAMES)
    prefill_launches = _attention_launches()
    cl, cc = model.prefill(cpu_params, cpu_batch, max_seq=WHISPER_FRAMES)
    errs = [(gl.cpu() - cl).abs().max().item()]
    cross_err = max((gc_[k].cpu() - cc[k]).abs().max().item()
                    for k in ("cross_k", "cross_v"))
    same = [int(gl.argmax()) == int(cl.argmax())]
    for _ in range(4):
        nxt = cl.argmax(-1)[:, None]
        gl, gc_ = model.decode(params, nxt.to(dev), gc_)
        cl, cc = model.decode(cpu_params, nxt, cc)
        errs.append((gl.cpu() - cl).abs().max().item())
        same.append(int(gl.argmax()) == int(cl.argmax()))
    launches = _attention_launches()
    res = {"phase": "encdec_crosscheck", "encoder_layers": 2,
           "decoder_layers": 2, "frames": WHISPER_FRAMES,
           "prompt": WHISPER_PROMPT, "decode_steps": 4,
           "max_abs_err": max(errs), "per_step_err": errs,
           "cross_kv_err": cross_err, "tolerance": tol,
           "argmax_agree": all(same), "prefill_launches": prefill_launches,
           "flash_launches": {"wgmma": launches["flash_wgmma"],
                              "tf32x3": launches["flash_tf32x3"]},
           "decode_launches": launches["decode_attention"]}
    log(json.dumps(res))
    check(prefill_launches == {"decode_attention": 0, "flash_wgmma": 0,
                               "flash_tf32x3": cfg.encoder_layers
                               + 2 * cfg.n_layers},
          f"encdec cross-check: prefill launches {prefill_launches}")
    check(launches["decode_attention"] == 4 * 2 * cfg.n_layers,
          f"encdec cross-check: {launches['decode_attention']} decode "
          "launches")
    check(max(errs + [cross_err]) <= tol,
          f"encdec cross-check: logits differ by {max(errs)}, cross K/V by "
          f"{cross_err}")
    check(all(same), "encdec cross-check: argmax tokens differ")
    return res


def phase_encdec_serve(dev):
    """whisper-large-v3 at full width in bf16 (32 encoder and 32 decoder
    layers, 1.54 B parameters), weights from the card's seeded generator:
    ``Model.prefill`` of 4 clips of 1,500 seeded frames and a 4-token
    prompt, then 64 greedy decode steps through ``Model.decode`` (the
    serving engine takes no frames), each ending in its tokens' copy to
    the host. Launch counters are zeroed just before and read just after:
    flash once an encoder layer and twice a decoder layer (all wgmma), the
    decode kernel twice a decoder layer a step, no plain version on the
    card. Then encode ms and prefill ms (medians of 3) apart."""
    from repro_torch.configs import get
    from repro_torch.models import build
    from repro_torch.models import transformer as T

    resident = _free_card()
    cfg = get(WHISPER_ARCH)                 # full width, bf16
    model = FiniteLogits(build(cfg))
    params = model.model.init(torch.Generator(dev).manual_seed(0))
    n_params = sum(p.numel() for p in _leaves(params))
    batch = _whisper_inputs(cfg, dev, WHISPER_CLIPS, seed=1)
    torch.cuda.synchronize()

    with PlainOnCard() as plain:
        _zero_attention_launches()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, max_seq=WHISPER_FRAMES)
        nxt = logits.argmax(-1)
        tokens = [nxt.cpu()]
        first_ms = 1e3 * (time.perf_counter() - t0)
        step_ms = []
        for _ in range(WHISPER_STEPS):
            t = time.perf_counter()
            logits, cache = model.decode(params, nxt[:, None], cache)
            nxt = logits.argmax(-1)
            tokens.append(nxt.cpu())         # the step's one host sync
            step_ms.append(1e3 * (time.perf_counter() - t))
        launches = _attention_launches()
    generated = torch.stack(tokens, dim=1)
    check(generated.shape == (WHISPER_CLIPS, WHISPER_STEPS + 1),
          f"whisper: tokens {tuple(generated.shape)}")
    check(bool(((generated >= 0) & (generated < cfg.vocab)).all()),
          "whisper: token out of vocab")
    check(bool(model.flag), "whisper: non-finite logits")
    want = {"decode_attention": 2 * cfg.n_layers * WHISPER_STEPS,
            "flash_wgmma": cfg.encoder_layers + 2 * cfg.n_layers,
            "flash_tf32x3": 0}
    check(launches == want, f"whisper launches {launches}, want {want}")
    check(not any(plain.calls.values()),
          f"plain versions ran on the card: {plain.calls}")
    check(cache["cross_k"].shape[2] == WHISPER_FRAMES
          and int(cache["pos"][0]) == WHISPER_PROMPT + WHISPER_STEPS,
          "whisper: cache sizes")
    peak = torch.cuda.max_memory_allocated() / 1e9

    def median_ms(fn, n=3):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
        return statistics.median(times)
    encode_ms = median_ms(lambda: T.encdec_encode(params, cfg,
                                                  batch["frames"]))
    prefill_ms = median_ms(lambda: model.model.prefill(
        params, batch, max_seq=WHISPER_FRAMES))
    res = {"phase": "encdec_serve", "model": cfg.name, "params": n_params,
           "dtype": cfg.dtype, "clips": WHISPER_CLIPS,
           "frames": WHISPER_FRAMES, "prompt": WHISPER_PROMPT,
           "decode_steps": WHISPER_STEPS,
           "first_token_ms": first_ms, "encode_ms": encode_ms,
           "prefill_ms": prefill_ms,
           "decode_step_ms_median": statistics.median(step_ms),
           "decode_step_ms_min": min(step_ms),
           "decode_tokens_per_s": WHISPER_CLIPS * WHISPER_STEPS
           / (1e-3 * sum(step_ms)),
           "cross_kv_gb": _nbytes([cache["cross_k"], cache["cross_v"]]) / 1e9,
           "launches": launches, "plain_calls_on_card": plain.calls,
           "resident_gb_before": resident, "peak_mem_gb": peak,
           "tokens_row0": generated[0].tolist()}
    log(json.dumps(res))
    return res, (model.model, params, batch, cache)


def phase_encdec_trace(model, params, batch, cache):
    """``profile_window`` over 3 decode steps of phase "encdec_serve"'s
    clips and over one prefill (4 clips: encode and prompt), beside the
    byte bound of a decode step: every decoder layer's weights, the tied
    embedding (the vocab projection), both cross caches and the self K/V
    slots read, over 3.35 TB/s."""
    cfg = model.cfg
    state = {"cache": cache}
    tok = batch["tokens"][:, :1]

    def step():
        logits, state["cache"] = model.decode(params, tok, state["cache"])
        return logits.argmax(-1).cpu()
    res = {"phase": "encdec_trace",
           "decode_step": profile_window("decode_step", step, 3),
           "prefill": profile_window("prefill", lambda: model.prefill(
               params, batch, max_seq=WHISPER_FRAMES), 1)}
    c = state["cache"]
    live = int(c["pos"].sum())
    parts = {"decoder_layers": _nbytes(params["dec_layers"]),
             "embed_as_head": _nbytes(params["embed"]),
             "cross_kv": _nbytes([c["cross_k"], c["cross_v"]]),
             "self_kv_read": live * cfg.n_layers * 2 * cfg.n_kv_heads
             * cfg.d_head * c["k"].element_size()}
    step_bytes = sum(parts.values())
    busy = res["decode_step"]["device_busy_ms"]
    res.update({"step_bytes": parts, "step_bytes_total": step_bytes,
                "step_bound_ms": 1e3 * step_bytes / HBM_BYTES_PER_S,
                "busy_over_bound": not_measured(
                    busy, 1e3 * step_bytes / HBM_BYTES_PER_S)})
    log(json.dumps(res))
    return res


MIXED_ROWS, MIXED_MAX_SEQ = 2, 2048


def phase_mixed_cache(dev):
    """gemma3-1b at full width, one local:global period deep, with
    ``mixed_cache=True``, float32: 2 rows decode W + 16 = 528 steps from
    token 0 (as in ``repro``, a mixed cache has no prefill), so each local
    layer's 512-slot ring wraps; in lockstep, the full-cache decode fed
    the same seeded tokens. Launch
    counters are zeroed just before and read just after: the decode kernel
    once a layer a step on each path. Reports the largest logit gap (bar
    1e-3: float32 on both paths; the ring hands the kernel the window's
    slots in another order, which moves only the summation order), step
    ms on each path, and the cache bytes of each at max_seq 2048."""
    import numpy as np

    from repro_torch.models import build

    tol = 1e-3
    resident = _free_card()
    cfg = gemma_period(mixed_cache=True, dtype="float32")
    mixed, full = build(cfg), build(dataclasses.replace(cfg,
                                                        mixed_cache=False))
    params = mixed.init(torch.Generator(dev).manual_seed(0))
    steps = cfg.window + 16
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (steps, MIXED_ROWS, 1))).to(dev)
    mc = mixed.init_cache(MIXED_ROWS, MIXED_MAX_SEQ, dev)
    fc = full.init_cache(MIXED_ROWS, MIXED_MAX_SEQ, dev)
    cache_bytes = {"mixed": _nbytes(mc), "full": _nbytes(fc)}
    torch.cuda.synchronize()
    gaps, ms = [], {"mixed": [], "full": []}
    with PlainOnCard() as plain:
        _zero_attention_launches()
        for i in range(steps):
            t = time.perf_counter()
            lm, mc = mixed.decode(params, toks[i], mc)
            torch.cuda.synchronize()
            ms["mixed"].append(1e3 * (time.perf_counter() - t))
            t = time.perf_counter()
            lf, fc = full.decode(params, toks[i], fc)
            torch.cuda.synchronize()
            ms["full"].append(1e3 * (time.perf_counter() - t))
            gaps.append((lm - lf).abs().max())
        launches = _attention_launches()
    gaps = torch.stack(gaps).cpu()
    res = {"phase": "mixed_cache", "model": cfg.name, "dtype": cfg.dtype,
           "rows": MIXED_ROWS, "window": cfg.window, "steps": steps,
           "max_seq": MIXED_MAX_SEQ, "max_logit_gap": gaps.max().item(),
           "max_logit_gap_after_wrap": gaps[cfg.window:].max().item(),
           "tolerance": tol,
           "step_ms_median": {k: statistics.median(v) for k, v in ms.items()},
           "cache_bytes": cache_bytes,
           "cache_ratio": cache_bytes["mixed"] / cache_bytes["full"],
           "launches": launches, "plain_calls_on_card": plain.calls,
           "resident_gb_before": resident,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(json.dumps(res))
    check(launches == {"decode_attention": 2 * cfg.n_layers * steps,
                       "flash_wgmma": 0, "flash_tf32x3": 0},
          f"mixed cache: launches {launches}")
    check(not any(plain.calls.values()),
          f"plain versions ran on the card: {plain.calls}")
    check(int(mc["pos"][0]) == steps and mc["k_local"].shape[2] == cfg.window,
          "mixed cache: ring size or cursor")
    check(res["max_logit_gap"] <= tol,
          f"mixed cache: logits part from the full cache by "
          f"{res['max_logit_gap']}")
    return res


def _jamba_cut():
    """jamba-1.5-large-398b at full width cut to one period (8 sublayers:
    attention and 7 Mamba-2; n_layers % attn_period must be 0) and 8 of
    its 16 experts: 25.8 B parameters, 51.6 GB in bf16 (one period with
    16 experts would be ~90 GB, past the card's 80)."""
    from repro_torch.configs import get
    return dataclasses.replace(get(JAMBA_ARCH), n_layers=8, n_experts=8)


def _hybrid_counts(cfg):
    """(attention sublayers, Mamba-2 sublayers, MoE sublayers) of a hybrid
    config."""
    from repro_torch.models.transformer import _hybrid_layout
    n_periods, P, moe_slots, _ = _hybrid_layout(cfg)
    return n_periods, n_periods * (P - 1), n_periods * len(moe_slots)


def phase_hybrid_crosscheck(dev):
    """jamba's one period at a narrower width that keeps its attention and
    SSD shapes (d_model 1024, 64 heads on 8 kv heads (G = 8), d_head 128;
    Mamba-2 32 heads of 64, state 128, chunk 128; 4 experts top-2, vocab
    65536), float32: a 300-token prompt (one routing group; each scan
    padded to 384) and 4 decode steps on the card against the same weights
    on the CPU. Logits within 1e-3, the routes kept bit for bit; the
    prefill launches flash once, the SSD scan 7 times; a decode step the
    decode kernel once."""
    import numpy as np

    from repro_torch.kernels.ssd_scan import ssd_cuda
    from repro_torch.models import build
    from repro_torch.models.moe import recording_routes

    tol = 1e-3
    cfg = dataclasses.replace(_jamba_cut(), d_model=1024, d_ff=2048,
                              n_experts=4, dtype="float32")
    n_attn, n_mamba, _ = _hybrid_counts(cfg)
    model = build(cfg)
    params = model.init(torch.Generator(dev).manual_seed(4))
    cpu_params = _to_cpu(params)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (1, 300)))

    def routed(fn):
        with recording_routes() as routes:
            out = fn()
        return out, [(i.cpu(), k.cpu()) for i, k in routes]
    _zero_attention_launches()
    ssd_cuda.launches = 0
    (gl, gc_), g_routes = routed(lambda: model.prefill(
        params, {"tokens": toks.to(dev)}, max_seq=512))
    prefill = dict(_attention_launches(), ssd_scan=ssd_cuda.launches)
    (cl, cc), c_routes = routed(lambda: model.prefill(
        cpu_params, {"tokens": toks}, max_seq=512))
    errs = [(gl.cpu() - cl).abs().max().item()]
    state_err = (gc_["ssm"].cpu() - cc["ssm"]).abs().max().item()
    same = [int(gl.argmax()) == int(cl.argmax())]
    for _ in range(4):
        nxt = cl.argmax(-1)[:, None]
        (gl, gc_), r = routed(lambda: model.decode(params, nxt.to(dev), gc_))
        g_routes += r
        (cl, cc), r = routed(lambda: model.decode(cpu_params, nxt, cc))
        c_routes += r
        errs.append((gl.cpu() - cl).abs().max().item())
        same.append(int(gl.argmax()) == int(cl.argmax()))
    launches = dict(_attention_launches(), ssd_scan=ssd_cuda.launches)
    same_routes = len(g_routes) == len(c_routes) and all(
        torch.equal(gi, ci) and torch.equal(gk, ck)
        for (gi, gk), (ci, ck) in zip(g_routes, c_routes))
    res = {"phase": "hybrid_crosscheck", "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.d_head],
           "ssm_heads": cfg.ssm_heads, "experts": cfg.n_experts,
           "prompt": 300, "decode_steps": 4, "max_abs_err": max(errs),
           "per_step_err": errs, "prefill_state_err": state_err,
           "tolerance": tol, "argmax_agree": all(same),
           "routes_identical": same_routes, "prefill_launches": prefill,
           "flash_launches": {"wgmma": launches["flash_wgmma"],
                              "tf32x3": launches["flash_tf32x3"]},
           "decode_launches": launches["decode_attention"],
           "ssd_launches": launches["ssd_scan"]}
    log(json.dumps(res))
    del params, cpu_params, gc_, cc
    check(prefill == {"decode_attention": 0, "flash_wgmma": 0,
                      "flash_tf32x3": n_attn, "ssd_scan": n_mamba},
          f"hybrid cross-check: prefill launches {prefill}")
    check(launches["decode_attention"] == 4 * n_attn
          and launches["ssd_scan"] == n_mamba,
          f"hybrid cross-check: launches {launches}")
    check(same_routes, "hybrid cross-check: the card kept other routes")
    check(max(errs) <= tol,
          f"hybrid cross-check: logits differ by {max(errs)}")
    check(all(same), "hybrid cross-check: argmax tokens differ")
    return res


def phase_hybrid_serve(dev):
    """jamba at full width in bf16, cut to one period and 8 experts
    (``_jamba_cut``), weights from the card's seeded generator, behind
    phase "serve"'s engine (4 slots, max_seq 2048, context 1024) with its
    requests (prompts {100, 300, 700, 1000} x 2, 16 new tokens each) at
    their exact lengths. Launch counters are zeroed just before and read
    just after: the decode kernel once an attention sublayer a step, flash
    (wgmma) once a prompt, the SSD scan once a Mamba-2 sublayer a prompt,
    no plain version on the card. Prefill ms by length, the real routes
    dropped at capacity by prompt length, the memory left by earlier
    phases and this phase's peak."""
    import numpy as np

    from repro_torch.kernels.ssd_scan import ssd_cuda
    from repro_torch.models import build
    from repro_torch.serve.engine import (EngineConfig, Request,
                                          ServingEngine)

    resident = _free_card()
    cfg = _jamba_cut()
    n_attn, n_mamba, n_moe = _hybrid_counts(cfg)
    model = RouteCounts(build(cfg))
    params = model.model.init(torch.Generator(dev).manual_seed(0))
    n_params = sum(p.numel() for p in _leaves(params))
    ecfg = EngineConfig(slots=4, max_seq=2048, context=1024, chips=16.0)
    engine = ServingEngine(model, params, ecfg, device=dev)
    rng = np.random.default_rng(0)
    lengths = [100, 300, 700, 1000] * 2
    reqs = [Request(i, rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=16) for i, n in enumerate(lengths)]
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()

    step_ms = []
    with PlainOnCard() as plain:
        _zero_attention_launches()
        ssd_cuda.launches = 0
        t0 = time.perf_counter()
        while len(engine.completed) < len(reqs) and engine.steps < 500:
            engine.step()
            step_ms.append(1e3 * engine.last_step_s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_attention_launches(), ssd_scan=ssd_cuda.launches)
    admitted = engine.admissions

    check(len(engine.completed) == len(reqs), "not every request completed")
    for r in engine.completed:
        check(len(r.generated) == 16, f"request {r.rid}: "
              f"{len(r.generated)} tokens")
        check(all(0 <= t < cfg.vocab for t in r.generated),
              f"request {r.rid}: token out of vocab")
    check(bool(model.flag), "non-finite logits")
    want = {"decode_attention": n_attn * engine.steps,
            "flash_wgmma": n_attn * admitted, "flash_tf32x3": 0,
            "ssd_scan": n_mamba * admitted}
    check(launches == want, f"hybrid launches {launches}, want {want}")
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
    res = {"phase": "hybrid_serve", "model": cfg.name,
           "cut": {"n_layers": cfg.n_layers, "n_experts": cfg.n_experts},
           "params": n_params, "weights_gb": _nbytes(params) / 1e9,
           "dtype": cfg.dtype, "requests": len(reqs),
           "prompt_lengths": lengths, "new_tokens_each": 16,
           "prompts_admitted": admitted, "engine_steps": engine.steps,
           "tokens_generated": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "decode_tokens_per_s": engine.tokens_out / wall,
           "decode_step_ms_median": statistics.median(step_ms),
           "decode_step_ms_min": min(step_ms),
           "prefill_ms_by_length": prefill_ms, "launches": launches,
           "plain_calls_on_card": plain.calls,
           "routes_dropped": _route_drops(model, n_moe),
           "resident_gb_before": resident, "peak_mem_gb": peak}
    log(json.dumps(res))
    return res, engine


def phase_hybrid_trace(engine):
    """``phase_trace`` on the hybrid engine (3 decode steps, one 1000-token
    prefill), beside the byte bound of a decode step: every weight but the
    embedding table (all experts enter the dense dispatch), the head, the
    K/V slots the rows attend to and the Mamba-2 states read and written,
    over 3.35 TB/s."""
    res = phase_trace(engine, name="hybrid_trace")
    p, c = engine.params, engine._cache
    periods = p["periods"]
    parts = {"experts": sum(_nbytes([{k: f[k] for k in ("up", "gate",
                                                        "down")}
                                     for f in pp["ffn_moe"]])
                            for pp in periods),
             "router": sum(_nbytes([f["router"] for f in pp["ffn_moe"]])
                           for pp in periods),
             "dense_ffn": sum(_nbytes(pp["ffn_dense"]) for pp in periods),
             "mamba": sum(_nbytes(pp["mamba"]) for pp in periods),
             "attention": sum(_nbytes(pp["attn"]) for pp in periods),
             "norms": sum(_nbytes([pp[k] for k in pp if k.endswith("ln")])
                          for pp in periods),
             "head": _nbytes(p["head"]),
             "states": 2 * _nbytes([c["conv"], c["ssm"]])}
    live = torch.clamp(c["pos"], max=engine.cfg.max_seq)
    mcfg = engine.model.cfg
    parts["kv_read"] = int(live.sum()) * len(periods) * 2 \
        * mcfg.n_kv_heads * mcfg.d_head * c["kv_k"].element_size()
    step_bytes = sum(parts.values())
    busy = res["decode_step"]["device_busy_ms"]
    res.update({"step_bytes": parts, "step_bytes_total": step_bytes,
                "step_bound_ms": 1e3 * step_bytes / HBM_BYTES_PER_S,
                "busy_over_bound": not_measured(
                    busy, 1e3 * step_bytes / HBM_BYTES_PER_S)})
    log(json.dumps(res))
    return res


# -- training: attention's backward kernel, gemma3-1b trained ------------------

TRAIN_ARCH = "gemma3-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 12
# launch/train.py's 3e-3 (its default, for the smoke cut) made the full
# width's loss rise after step 10 on the H100 (12.718 -> 12.811 in 12
# steps); 1e-3 falls (12.718 -> 12.646)
TRAIN_LR = 1e-3
BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_backward.cu"
# the backward against its plain version: 1e-4 of each gradient's largest
# entry in float32 (the same sums in another order), 5e-2 in bf16 (inputs,
# P and dS rounded to bf16); the forward's lse within 1e-4 in float32 and
# 1e-3 in bf16 (float32 scores on both sides)
BWD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
LSE_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
# the backward's CUDA kernels, by names no other kernel's holds
BWD_KERNELS = ("delta_kernel", "dkdv_kernel", "dq_kernel", "dq_ds_kernel",
               "sum_partials_kernel")


def train_cases(dev, dtype):
    """The backward kernel's inputs: gemma3-1b's training shape (4 rows of
    1,024 tokens, 4 query heads on 1 kv head, d_head 256, causal) on a
    local layer (window 512) and a global one; the cross-check's ragged
    600-token row; and whisper's decoder over its frames (G = 1, d_head 64,
    not causal, S = 1,500 // 8 = 187 tokens against T = 1,500 frames, 4
    clips). Each case is (name, q, k, v, do, window, causal)."""
    g = torch.Generator(dev).manual_seed(23)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    out = []
    for window in (512, 0):
        out.append((f"gemma_w{window}", randn(4, 4, 1024, 256),
                    randn(4, 1, 1024, 256), randn(4, 1, 1024, 256),
                    randn(4, 4, 1024, 256), window, True))
    out.append(("ragged_S600", randn(1, 4, 600, 256), randn(1, 1, 600, 256),
                randn(1, 1, 600, 256), randn(1, 4, 600, 256), 512, True))
    out.append(("whisper_S187_T1500", randn(4, 20, 187, 64),
                randn(4, 20, 1500, 64), randn(4, 20, 1500, 64),
                randn(4, 20, 187, 64), 0, False))
    return out


def phase_train_kernels(dev):
    """The backward kernel and the forward's ``lse`` against their plain
    versions on the card, float32 and bf16, on ``train_cases``; times of the
    backward (device and call ms, its plain version, and SDPA's backward
    alone on a retained graph, which the port never calls), the forward
    with and without ``lse`` beside its plain version and SDPA's forward
    (the library yardstick, never called by the port), the bounds (float32
    also on the tensor cores: 3 x flops over TF32's rate), the backward's
    CTAs a pass from ``backward_plan``, and the CUDA kernels a backward
    call launches (the plan's 3 or 4)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        backward_work, flash_attention_backward_cuda, flash_attention_cuda,
        forward_work, plan_of)

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for name, q, k, v, do, window, causal in train_cases(dev, dtype):
            out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                            window=window, return_lse=True)
            want_lse = ref.flash_attention_lse_reference(
                q, k, causal=causal, window=window)
            got = flash_attention_backward_cuda(q, k, v, out, lse, do,
                                                causal=causal, window=window)
            again = flash_attention_backward_cuda(q, k, v, out, lse, do,
                                                  causal=causal,
                                                  window=window)
            want = ref.flash_attention_backward_reference(
                q, k, v, out, lse, do, causal=causal, window=window)
            torch.cuda.synchronize()
            lse_err = (lse - want_lse).abs().max().item()
            errs = [(a.float() - b.float()).abs().max().item()
                    for a, b in zip(got, want)]
            rel = [e / b.float().abs().max().item()
                   for e, b in zip(errs, want)]
            check(lse_err <= LSE_TOL[dname],
                  f"lse {name} {dname}: error {lse_err}")
            check(max(rel) <= BWD_TOL[dname],
                  f"backward {name} {dname}: errors over the largest entry "
                  f"{rel}")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"backward {name} {dname}: two calls differ")
            B, H, S, D = q.shape
            KH, T = k.shape[1], k.shape[2]
            plan = plan_of(q, k, causal=causal, window=window)
            nbytes, flops = backward_work(q, k, causal=causal, window=window)
            chains = {p: (items[:, 4] - items[:, 3]).tolist() for p, items
                      in (("kv", plan.kv_items), ("q", plan.q_items))}
            row = {"kernel": "flash_attention_backward", "case": name,
                   "dtype": dname, "shape": [B, H, KH, S, T, D],
                   "causal": causal, "window": window,
                   "max_abs_err": max(errs), "max_rel_err": max(rel),
                   "lse_err": lse_err, "bitwise_repeatable": True,
                   "bound": bound_ms(nbytes, flops, dname),
                   "dkdv_ctas": len(plan.kv_items),
                   "dq_ctas": len(plan.q_items),
                   "split_chains": len(plan.reduce),
                   "dq_block": plan.dq_block, "ds_tiles": plan.ds_tiles,
                   "chain_max_mean": {
                       p: [max(c), sum(c) / len(c)] for p, c in chains.items()}}
            fwd_bytes, fwd_flops = forward_work(q, k, causal=causal,
                                                window=window)
            row["fwd_bound"] = bound_ms(fwd_bytes, fwd_flops, dname)
            if dtype == torch.float32:
                row["bound_tf32x3"] = (1e3 * max(
                    nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS),
                    "operations")
                row["fwd_bound_tf32x3"] = (1e3 * max(
                    fwd_bytes / HBM_BYTES_PER_S, 3 * fwd_flops / TF32_FLOPS),
                    "operations")

            def call():
                return flash_attention_backward_cuda(
                    q, k, v, out, lse, do, causal=causal, window=window)
            row["ms"], row["call_ms"] = time_ms([call], 10)
            row["kernels_per_call"], row["kernel_names"] = \
                kernels_per_call(call, calls=3)
            check(row["kernels_per_call"] == plan.kernels,
                  f"backward {name} {dname}: {row['kernels_per_call']} "
                  f"kernels a call ({row['kernel_names']}), want "
                  f"{plan.kernels}")
            row["device_ms_of"] = profile_window(
                f"backward_{name}", call, 5, share_of=BWD_KERNELS)[
                "device_ms_of"]
            row["plain_ms"], row["plain_call_ms"] = time_ms([
                lambda: ref.flash_attention_backward_reference(
                    q, k, v, out, lse, do, causal=causal, window=window)], 3)
            row["fwd_ms"], _ = time_ms([lambda: flash_attention_cuda(
                q, k, v, causal=causal, window=window)], 10)
            row["fwd_lse_ms"], _ = time_ms([lambda: flash_attention_cuda(
                q, k, v, causal=causal, window=window, return_lse=True)], 10)
            row["fwd_plain_ms"], _ = time_ms([
                lambda: ref.flash_attention_reference(
                    q, k, v, causal=causal, window=window)], 3)

            # SDPA, forward and backward: the kv heads expanded (inside the
            # backward's retained graph over leaves of the kernel's shapes,
            # so dK and dV are summed over a kv head's query heads)
            G = H // KH
            mask = ref.attention_mask(S, T, causal, window, dev) \
                if window or (causal and S != T) else None

            def sdpa(a, b, c):
                if mask is not None:
                    return F.scaled_dot_product_attention(a, b, c,
                                                          attn_mask=mask)
                return F.scaled_dot_product_attention(a, b, c,
                                                      is_causal=causal)
            kx, vx = (t.repeat_interleave(G, 1) if G > 1 else t
                      for t in (k, v))
            lib_fwd = sdpa(q, kx, vx)
            torch.cuda.synchronize()
            row["fwd_library_err"] = (lib_fwd.float()
                                      - out.float()).abs().max().item()
            row["fwd_library_ms"], _ = time_ms([lambda: sdpa(q, kx, vx)], 10)
            del lib_fwd, kx, vx
            lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
            kk = lk.repeat_interleave(G, 1) if G > 1 else lk
            vv = lv.repeat_interleave(G, 1) if G > 1 else lv
            lib_out = sdpa(lq, kk, vv)

            def sdpa_backward():
                return torch.autograd.grad(lib_out, (lq, lk, lv), do,
                                           retain_graph=True)
            lib = sdpa_backward()
            torch.cuda.synchronize()
            row["library_err"] = max((a.float() - b.float()).abs().max().item()
                                     for a, b in zip(lib, want))
            row["library_ms"], row["library_call_ms"] = time_ms(
                [sdpa_backward], 10)
            del lib_out, lib, lq, lk, lv, kk, vv
            rows.append(row)
            log(f"backward {name} {dname}: {row}")
    return {"phase": "train_kernels", "cases": rows}


def _grads_of(model, params, batch):
    from repro_torch.launch.steps import _value_and_grad
    loss, metrics, grads = _value_and_grad(model, params, batch)
    return float(loss), grads


def phase_train_crosscheck(dev):
    """gemma3-1b at full width cut to 2 layers (one local, one global, as
    phase "crosscheck" cuts it), float32, one 600-token row (past the 512
    window, so the local mask bites): the loss and every gradient leaf on
    the card against the same weights on the CPU, the flash forward and
    backward kernels once a layer; then one AdamW update on each side from
    the SAME gradients (the CPU's; Adam's first step is ~lr x sign(g), so
    gradients that differ in rounding give updates that differ where g is
    ~0)."""
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_cuda, reset_launches)
    from repro_torch.models import build
    from repro_torch.train.optimizer import AdamWConfig, adamw
    from repro_torch.train.tree import leaves

    # the loss within 1e-4 and each gradient leaf within 1e-3 of its
    # largest entry (or 1e-8): the same float32 arithmetic (no TF32) in
    # another summation order; a wrong mask, window or position moves
    # them by orders more. The update: within 1e-6 (lr 3e-4 at step 1).
    tol_loss, tol_grad, tol_update = 1e-4, 1e-3, 1e-6
    cfg = dataclasses.replace(get(TRAIN_ARCH), n_layers=2,
                              local_global_period=2, dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator(dev).manual_seed(1))
    cpu_params = _to_cpu(params)
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (1, 600)))
             for k in ("tokens", "labels")}
    reset_launches()
    gl, gg = _grads_of(model, params, {k: v.to(dev)
                                       for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = {"flash_attention_fp32": flash_attention_cuda.launches,
                "flash_attention_backward":
                    flash_attention_backward_cuda.launches}
    cl, cg = _grads_of(model, cpu_params, batch)
    errs = [((a.cpu() - b).abs().max().item(), b.abs().max().item())
            for a, b in zip(gg, cg)]
    worst = max(e / max(s, 1e-30) for e, s in errs if s > 1e-5)
    check(launches == {"flash_attention_fp32": cfg.n_layers,
                       "flash_attention_backward": cfg.n_layers},
          f"train cross-check: launches {launches}")
    check(abs(gl - cl) <= tol_loss, f"train cross-check: loss {gl} vs {cl}")
    check(all(e <= max(tol_grad * s, 1e-8) for e, s in errs),
          f"train cross-check: gradients differ (worst {worst} of the "
          "largest entry)")

    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=12)
    init, update = adamw(opt_cfg)
    new_gpu, _, m_gpu = update([g.to(dev) for g in cg], init(leaves(params)),
                               leaves(params))
    new_cpu, _, m_cpu = update(cg, init(leaves(cpu_params)),
                               leaves(cpu_params))
    upd_err = max((a.cpu() - b).abs().max().item()
                  for a, b in zip(new_gpu, new_cpu))
    check(upd_err <= tol_update, f"train cross-check: AdamW updates differ "
          f"by {upd_err}")
    res = {"phase": "train_crosscheck", "layers": ["local", "global"],
           "tokens": 600, "loss_gpu": gl, "loss_cpu": cl,
           "loss_err": abs(gl - cl), "grad_leaves": len(errs),
           "grad_worst_rel_err": worst,
           "grad_max_abs_err": max(e for e, _ in errs),
           "update_max_abs_err": upd_err,
           "grad_norm": [float(m_gpu["grad_norm"]),
                         float(m_cpu["grad_norm"])],
           "tolerance": {"loss": tol_loss, "grad_rel": tol_grad,
                         "update": tol_update},
           "launches": launches}
    log(json.dumps(res))
    return res


def phase_train(dev, steps=TRAIN_STEPS):
    """The slice: gemma3-1b at full width, one local:global period deep
    (``PERIOD_LAYERS``), float32, seeded weights, trained by the port's
    ``Trainer`` through ``make_train_step`` on
    ``TokenPipeline(vocab=262144, batch=4, seq=1024)`` with
    ``AdamWConfig(lr=TRAIN_LR, warmup_steps=10, total_steps=steps)`` as
    ``launch/train.py`` builds it (``--lr 1e-3``: ``TRAIN_LR``),
    checkpointing into a temporary directory
    at the end. Checks: every loss and grad norm finite, the last loss
    below the first, the flash forward and backward kernels once a layer a
    step, peak memory under 80 GB; the final checkpoint restored by a
    resumed ``Trainer`` into fresh tensors, bitwise equal, at the saved
    step. Reports step ms, tokens/s against the step's bound (6 N tokens
    over 67 TFLOP/s), peak memory, the checkpoint's save and restore
    seconds, and a ``profile_window`` over 2 steps."""
    import tempfile

    from repro_torch.configs import get
    from repro_torch.data import TokenPipeline
    from repro_torch.device import upload
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_cuda, reset_launches)
    from repro_torch.launch import make_debug_mesh, make_train_step
    from repro_torch.models import build
    from repro_torch.train.optimizer import AdamWConfig, adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.train.tree import leaves

    resident = _free_card()
    cfg = dataclasses.replace(get(TRAIN_ARCH), n_layers=PERIOD_LAYERS,
                              dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    n_params = sum(p.numel() for p in leaves(params))
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=10, total_steps=steps)
    init, _ = adamw(opt_cfg)
    bundle = make_train_step(cfg, make_debug_mesh(), TRAIN_BATCH, TRAIN_SEQ,
                             opt_cfg=opt_cfg)
    step_fn = bundle.fn
    pipeline = TokenPipeline(vocab=cfg.vocab, batch=TRAIN_BATCH,
                             seq=TRAIN_SEQ)

    def to_device(b):
        return {k: upload(v, dev) for k, v in b.items()}

    with tempfile.TemporaryDirectory() as ckpt_dir:
        tcfg = TrainerConfig(total_steps=steps, ckpt_every=10 ** 9,
                             ckpt_dir=ckpt_dir, log_every=10 ** 9)
        trainer = Trainer(step_fn, params, init(params), pipeline, tcfg,
                          to_device=to_device)
        saves = []
        save = trainer.ckpt.save

        def timed_save(*a, **kw):
            t = time.perf_counter()
            save(*a, **kw)
            saves.append(time.perf_counter() - t)
        trainer.ckpt.save = timed_save
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        hist = trainer.run()
        wall = time.perf_counter() - t0
        launches = {"flash_attention_fp32": flash_attention_cuda.launches,
                    "flash_attention_backward":
                        flash_attention_backward_cuda.launches}
        peak = torch.cuda.max_memory_allocated() / 1e9

        # a resumed Trainer restores the final checkpoint into fresh tensors
        resumed = Trainer(step_fn, trainer.params, trainer.opt_state,
                          pipeline, tcfg, to_device=to_device)
        t = time.perf_counter()
        start = resumed.maybe_restore(shardings=bundle.in_shardings[:2])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        same = all(torch.equal(a, b) and a.device == dev for a, b in zip(
            leaves((resumed.params, resumed.opt_state)),
            leaves((trainer.params, trainer.opt_state))))
        ckpt_bytes = sum(f.stat().st_size for f in
                         Path(ckpt_dir).rglob("*") if f.is_file())
        del resumed

    with torch.no_grad():           # the final weights on two seen batches
        seen = {f"batch_{i}": float(model.loss(trainer.params, to_device(
            pipeline.batch_at(i)))[0]) for i in (0, steps - 1)}
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    step_ms = [1e3 * h["time_s"] for h in hist]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    med = statistics.median(step_ms[1:])
    bound = 1e3 * 6 * n_params * tokens / PEAK_FLOPS["float32"]
    batch = to_device(pipeline.batch_at(steps))
    state = [trainer.params, trainer.opt_state]

    def one_step():
        state[0], state[1], _ = step_fn(state[0], state[1], batch)
    prof = profile_window("train_step", one_step, 2, share_of=BWD_KERNELS)
    of = prof["device_ms_of"]
    prof["backward_kernel_share"] = not_measured(
        None if None in of.values() else sum(of.values()),
        prof["device_busy_ms"])
    res = {"phase": "train", "model": cfg.name, "params": n_params,
           "dtype": cfg.dtype, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": len(hist), "loss": losses, "grad_norm": norms,
           "lr": [h["lr"] for h in hist], "final_loss_on": seen,
           "step_ms": step_ms,
           "step_ms_median": med, "tokens_per_s": tokens / (med / 1e3),
           "step_bound_ms": bound, "wall_s": wall, "launches": launches,
           "peak_mem_gb": peak, "resident_before_gb": resident,
           "ckpt_save_s": saves, "ckpt_restore_s": restore_s,
           "ckpt_bytes": ckpt_bytes, "restored_step": start,
           "restored_bitwise": same, "profile": prof}
    log(json.dumps(res))
    finite = all(math.isfinite(x) for x in losses + norms)
    check(len(hist) == steps, f"train: {len(hist)} steps of {steps}")
    check(finite, f"train: non-finite loss or grad norm {losses} {norms}")
    check(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    check(launches == {"flash_attention_fp32": cfg.n_layers * steps,
                       "flash_attention_backward": cfg.n_layers * steps},
          f"train: launches {launches} vs {cfg.n_layers} a step")
    check(peak < 80.0, f"train: peak memory {peak} GB")
    check(start == steps, f"train: resumed at {start}, saved at {steps}")
    check(same, "train: the restored checkpoint differs from the state")
    return res, _trained(cfg, trainer.params, trainer.opt_state, med)


def _trained(cfg, params, opt_state, step_ms_median):
    """What phase "dryrun" reads of a trained state: its leaves' shapes,
    dtypes and devices, their summed bytes, and the median step."""
    from repro_torch.train.tree import leaves
    state = leaves((params, opt_state))
    return {"cfg": cfg, "leaves": [(tuple(t.shape), t.dtype) for t in state],
            "devices": sorted({str(t.device) for t in state}),
            "nbytes": sum(t.nbytes for t in state),
            "step_ms_median": step_ms_median}


# -- training the SSD scan: mamba2-370m --------------------------------------------

SSM_TRAIN_ARCH = "mamba2-370m"
SSD_BWD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan_backward.cu"
# the SSD backward's CUDA kernels and the forward's, by names no other
# kernel's holds
SSD_BWD_KERNELS = ("ssd_bwd_chunk_kernel", "state_backward_kernel",
                   "ssd_bwd_local_kernel", "ssd_bwd_sum_kernel")
# other partitions timed at mamba2's shape: (heads a CTA, CTAs a cluster)
SSD_BWD_PARTITIONS = ((4, 8), (4, 2), (8, 4), (8, 1), (2, 2), (1, 8))
SSD_FWD_KERNELS = ("chunk_state_kernel", "state_passing_kernel",
                   "chunk_scan_kernel")
GRAD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinitial")


def ssd_backward_cases(dev, dtype):
    """The SSD backward's inputs, with ``ssd_cases``' distributions (32
    heads of 64, state 128, chunk 128) and a cotangent dy ~ N(0, 1):
    mamba2-370m's training shape (4 rows of 1,024 tokens); jamba's
    full-width Mamba-2 sublayer (256 heads of 64) at l = 384 and 1024; two
    rows of 512 with an initial state and a final-state cotangent; one
    chunk (l = 64); a rank's local shapes on meshes of several cards
    (``MESH_SSD_SHAPES``, "mesh_h16" ...). Each case is (name, [x, dt, A,
    B, C], initial state, dy, dfinal)."""
    g = torch.Generator(dev).manual_seed(29)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    out = []
    for name, b, l, h, state in (("mamba2_b4_l1024", 4, 1024, 32, False),
                                 ("h256_b1_l384", 1, 384, 256, False),
                                 ("h256_b1_l1024", 1, 1024, 256, False),
                                 ("b2_l512_state", 2, 512, 32, True),
                                 ("b1_l64", 1, 64, 32, False),
                                 *((f"mesh_h{h}_b{b}_l{l}", b, l, h, False)
                                   for b, l, _, h in MESH_SSD_SHAPES)):
        p, n = 64, 128
        args = [randn(b, l, h, p) * 0.5,
                torch.nn.functional.softplus(randn(b, l, h)),
                -torch.exp(randn(h) * 0.3),
                randn(b, l, n) * 0.5, randn(b, l, n) * 0.5]
        init = randn(b, h, p, n) * 0.5 if state else None
        dy = randn(b, l, h, p)
        dfin = randn(b, h, p, n) if state else None
        out.append((name, [t.to(dtype) for t in args],
                    None if init is None else init.to(dtype), dy.to(dtype),
                    None if dfin is None else dfin.to(dtype)))
    return out


def phase_ssd_backward_kernels(dev):
    """The SSD scan's backward kernel (``csrc/ssd_scan_backward.cu``: four
    CUDA kernels a call, counted with the profiler) against its plain
    version (``ref.ssd_backward_reference``) on ``ssd_backward_cases``, in
    float32 (1e-4 of each gradient's largest entry) and bf16 (5e-2), the
    forward's cs and prev from the forward kernel; two calls bitwise equal.
    Each row names its partition (``backward_plan`` on this card's
    capacity: heads a CTA, CTAs a cluster, clusters a (row, chunk), CTAs).
    Times: the backward (device and call ms), its plain version, the
    forward kernel at the same shapes (with its plain version and bound),
    and, on mamba2's case, each of the four kernels' device ms (the later
    three start behind the one before and wait for it, so theirs include
    some waiting) and the device ms of ``SSD_BWD_PARTITIONS``; the bound
    from ``ssd_scan.backward_work``, the function's own bytes (inputs, the
    forward's cs and prev, gradients) over 3.35 TB/s against its flops
    over 67 or 989 TFLOP/s; the bytes of the kernel's float32 dB/dC
    partials (``backward_partials_bytes``) beside it, not in it. No single
    PyTorch call computes this function: ``library_ms`` is null. float32
    runs three TF32 tensor-core products for each product, so its rows
    also carry that bound (3 x flops over 494.7 TFLOP/s, or the bytes)."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.ssd_scan import (BackwardPlan, _capacity,
                                              backward_partials_bytes,
                                              backward_plan,
                                              backward_with_plan,
                                              backward_work,
                                              ssd_backward_cuda, ssd_cuda)

    rows, chunk = [], 128
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for name, args, init, dy, dfin in ssd_backward_cases(dev, dtype):
            _, _, cs, prev = ssd_cuda(*args, chunk=chunk, initial_state=init,
                                      return_states=True)

            def call():
                return ssd_backward_cuda(*args, dy, cs, prev, dfin,
                                         chunk=chunk)
            ck = min(chunk, args[0].shape[1])
            got, again = call(), call()
            want = ref.ssd_backward_reference(*args, dy, dfin, chunk=ck,
                                              initial_state=init)
            torch.cuda.synchronize()
            errs, rel = {}, {}
            for key, a, w in zip(GRAD_NAMES, got, want):
                check(bool(torch.isfinite(a).all()),
                      f"ssd backward {name} {dname}: non-finite {key}")
                errs[key] = (a.float() - w.float()).abs().max().item()
                rel[key] = errs[key] / max(w.float().abs().max().item(),
                                           1e-30)
            # BWD_TOL: 1e-4 of each gradient's largest entry in float32
            # (the same sums in another order), 5e-2 in bf16 (bf16 inputs
            # and forward states, one TF32 product for each)
            check(max(rel.values()) <= BWD_TOL[dname],
                  f"ssd backward {name} {dname}: errors over the largest "
                  f"entry {rel}")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"ssd backward {name} {dname}: two calls differ")
            x, B = args[0], args[3]
            b, l, h, p = x.shape
            n = B.shape[-1]
            nbytes, flops = backward_work(b, l, h, p, n, ck,
                                          x.element_size(),
                                          dfinal=dfin is not None)
            capacity = _capacity(dev.index, ck, n, p,
                                 _build.DTYPE_CODES[dtype])
            plan = backward_plan(b, l, h, ck, capacity)
            precision = "tf32x3" if dtype == torch.float32 else "tf32"
            row = {"kernel": "ssd_scan_backward", "case": name,
                   "dtype": dname, "shape": [b, l, h, p, n, chunk],
                   "max_abs_err": max(errs.values()), "errors": errs,
                   "max_rel_err": max(rel.values()), "rel_errors": rel,
                   "tolerance_rel": BWD_TOL[dname],
                   "bitwise_repeatable": True, "bytes": nbytes,
                   "plan": dataclasses.astuple(plan),
                   "partials_bytes": backward_partials_bytes(
                       b, l, n, plan.clusters),
                   "flops": flops, "bound": bound_ms(nbytes, flops, dname),
                   "variant": f"{precision}, {plan.group} heads a CTA, "
                              f"clusters of {plan.cluster}",
                   "library_ms": None}
            if dtype == torch.float32:
                row["bound_tf32x3"] = (1e3 * max(
                    nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS),
                    "operations" if 3 * flops / TF32_FLOPS
                    > nbytes / HBM_BYTES_PER_S else "bytes")
            row["ms"], row["call_ms"] = time_ms([call], 10)
            row["kernels_per_call"], row["kernel_names"] = \
                kernels_per_call(call, calls=3)
            check(row["kernels_per_call"] == len(SSD_BWD_KERNELS),
                  f"ssd backward {name} {dname}: {row['kernels_per_call']} "
                  f"kernels a call ({row['kernel_names']})")
            if name == "mamba2_b4_l1024":
                row["device_ms_of"] = profile_window(
                    f"ssd_backward_{name}_{dname}", call, 3,
                    share_of=SSD_BWD_KERNELS)["device_ms_of"]
                row["capacity"] = capacity
                row["partitions"] = {}
                for g, cl in SSD_BWD_PARTITIONS:
                    other = BackwardPlan.of(b * (l // ck), h, g, cl)
                    row["partitions"][f"g{g}_cl{cl}"] = time_ms([
                        lambda plan=other: backward_with_plan(
                            *args, dy, cs, prev, dfin, chunk=chunk,
                            plan=plan)], 10)[0]
            row["plain_ms"], row["plain_call_ms"] = time_ms([
                lambda: ref.ssd_backward_reference(
                    *args, dy, dfin, chunk=ck, initial_state=init)], 3)
            row["fwd_ms"], row["fwd_call_ms"] = time_ms([
                lambda: ssd_cuda(*args, chunk=chunk, initial_state=init)],
                10)
            row["fwd_plain_ms"], _ = time_ms([
                lambda: ref.ssd_reference(*args, chunk=ck,
                                          initial_state=init)], 3)
            row["fwd_bound"] = bound_ms(*_ssd_work(args, init, ck), dname)
            del got, again, want
            rows.append(row)
            log(f"ssd backward {name} {dname}: {row}")
    return {"phase": "ssd_backward_kernels", "cases": rows}


def _ssd_launches():
    from repro_torch.kernels.ssd_scan import ssd_backward_cuda, ssd_cuda
    return {"ssd_scan": ssd_cuda.launches,
            "ssd_scan_backward": ssd_backward_cuda.launches}


def _zero_ssd_launches():
    from repro_torch.kernels.ssd_scan import ssd_backward_cuda, ssd_cuda
    ssd_cuda.launches = ssd_backward_cuda.launches = 0


def _worst_rel(got, want):
    """The largest of the leaves' max |got - want| over their largest
    |want| entry (leaves whose largest entry passes 1e-5)."""
    return max((a.double() - b.double()).abs().max().item()
               / b.double().abs().max().item()
               for a, b in zip(got, want) if b.abs().max().item() > 1e-5)


def _loss_and_grads_both(model, params, batch, dev, model64=None):
    """The loss and its gradient leaves on the card (launch counts read
    just after; no plain version on the card) and on the CPU from the same
    weights; with ``model64`` also on the CPU in float64. Returns (card
    loss, CPU loss, card leaves on the CPU, CPU leaves, float64 leaves or
    None, card launches)."""
    from repro_torch.kernels.flash_attention import \
        flash_attention_backward_cuda
    from repro_torch.train.tree import map_tree
    cpu_params = _to_cpu(params)
    _zero_ssd_launches()
    _zero_attention_launches()
    with PlainOnCard() as plain:
        gl, gg = _grads_of(model, params, {k: v.to(dev)
                                           for k, v in batch.items()})
        torch.cuda.synchronize()
    launches = dict(_ssd_launches(), **_attention_launches(),
                    flash_attention_backward=flash_attention_backward_cuda
                    .launches)
    check(not any(plain.calls.values()),
          f"ssm train cross-check: plain versions on the card {plain.calls}")
    gg = [g.cpu() for g in gg]
    cl, cg = _grads_of(model, cpu_params, batch)
    g64 = None
    if model64 is not None:
        _, g64 = _grads_of(model64, map_tree(torch.Tensor.double,
                                             cpu_params), batch)
    return gl, cl, gg, cg, g64, launches


# A Mamba-2 layer's per-head leaves: each entry a sum over every position
# of a row, so float32 in another order stands ~1e-4 of the largest entry
# from float64 on either side (PERF.md section 6)
PER_HEAD_LEAVES = ("A_log", "dt_bias", "D")


def phase_ssm_train_crosscheck(dev):
    """The loss and every gradient leaf on the card against the CPU, float32
    on both sides in another summation order: the loss within 1e-4, each
    leaf within 1e-4 of its largest entry (or 1e-8), the kernels' float32
    bar and "train_crosscheck"'s loss bar, except the per-head leaves (A_log,
    dt_bias, D), held at 3e-4: the CPU's own float32 run stands ~1e-4 from
    float64 there. mamba2-370m at full width cut to 2 layers on a ragged
    600-token row (the model pads it to 640, dt = 0 on the pad), the SSD
    forward and backward kernels once a layer; a float64 run on the CPU is
    made too, and the card must stand within 3e-4 of it on every leaf. And
    jamba's period at ``phase_hybrid_crosscheck``'s narrow cut (d_model
    1024, 4 experts) on that phase's 300-token prompt (whose routes the
    card keeps bit for bit there) with labels of its own: the SSD kernels
    7 times, the float32 flash forward and backward once."""
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.models import build
    from repro_torch.train.tree import stack_keys

    tol_loss, tol_grad, tol_head = 1e-4, 1e-4, 3e-4
    res = {"phase": "ssm_train_crosscheck",
           "tolerance": {"loss": tol_loss, "grad_rel": tol_grad,
                         "per_head_grad_rel": tol_head,
                         "float64_rel": tol_head}}
    cfg = dataclasses.replace(get(SSM_TRAIN_ARCH), n_layers=2,
                              dtype="float32")
    jcfg = dataclasses.replace(_jamba_cut(), d_model=1024, d_ff=2048,
                               n_experts=4, dtype="float32")
    n_attn, n_mamba, _ = _hybrid_counts(jcfg)
    rng = np.random.default_rng(31)
    jtoks = np.random.default_rng(9).integers(0, jcfg.vocab, (1, 300))
    cases = (
        ("mamba2", cfg, 5, {"tokens": rng.integers(0, cfg.vocab, (1, 600)),
                            "labels": rng.integers(0, cfg.vocab, (1, 600))},
         {"ssd_scan": 2, "ssd_scan_backward": 2}),
        ("jamba", jcfg, 4, {"tokens": jtoks,
                            "labels": rng.integers(0, jcfg.vocab, (1, 300))},
         {"ssd_scan": n_mamba, "ssd_scan_backward": n_mamba,
          "flash_tf32x3": n_attn, "flash_attention_backward": n_attn}))
    for key, c, seed, batch, want in cases:
        model = build(c)
        model64 = build(dataclasses.replace(c, dtype="float64")) \
            if key == "mamba2" else None
        params = model.init(torch.Generator(dev).manual_seed(seed))
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        gl, cl, gg, cg, g64, launches = _loss_and_grads_both(
            model, params, batch, dev, model64)
        head = [k[-1] in PER_HEAD_LEAVES for k in stack_keys(params)]
        errs = [((a - b).abs().max().item(), b.abs().max().item())
                for a, b in zip(gg, cg)]
        bars = [tol_head if hd else tol_grad for hd in head]

        def worst(per_head):
            return max((e / max(s, 1e-30) for (e, s), hd in zip(errs, head)
                        if hd == per_head and s > 1e-5), default=0.0)
        vs64 = None if g64 is None else {"card": _worst_rel(gg, g64),
                                         "cpu": _worst_rel(cg, g64)}
        res[key] = {"layers": c.n_layers, "d_model": c.d_model,
                    "tokens": batch["tokens"].shape[1], "loss_gpu": gl,
                    "loss_cpu": cl, "loss_err": abs(gl - cl),
                    "grad_leaves": len(errs), "per_head_leaves": sum(head),
                    "grad_worst_rel_err": worst(False),
                    "per_head_worst_rel_err": worst(True),
                    "grad_max_abs_err": max(e for e, _ in errs),
                    "worst_rel_to_float64": vs64, "launches": launches}
        log(json.dumps(res[key]))
        del model, model64, params, gg, cg, g64
        check({k: launches[k] for k in want} == want
              and all(v == 0 for k, v in launches.items() if k not in want),
              f"ssm train cross-check {key}: launches {launches}, want "
              f"{want}")
        check(abs(gl - cl) <= tol_loss,
              f"ssm train cross-check {key}: loss {gl} vs {cl}")
        check(all(e <= max(t * s, 1e-8) for (e, s), t in zip(errs, bars)),
              f"ssm train cross-check {key}: gradients differ (worst "
              f"{res[key]['grad_worst_rel_err']} of the largest entry, "
              f"per-head {res[key]['per_head_worst_rel_err']})")
        check(vs64 is None or vs64["card"] <= tol_head,
              f"ssm train cross-check {key}: the card's gradients stand "
              f"{vs64} from float64")
    return res


def phase_ssm_train(dev, steps=TRAIN_STEPS):
    """mamba2-370m, all 48 layers at full width, float32, seeded weights,
    trained by the port's ``Trainer`` through ``make_train_step`` on
    ``TokenPipeline(vocab=50280, batch=4, seq=1024)`` with
    ``AdamWConfig(lr=TRAIN_LR, warmup_steps=10, total_steps=steps)``, as
    phase "train" trains gemma3-1b, without the checkpoint (phase "train"
    covers it: the Trainer's save is a no-op here). Checks: every loss and
    grad norm finite, the last loss below the first, the SSD forward and
    backward kernels 48 times a step, no plain version on the card, peak
    memory under 80 GB. Reports step ms, tokens/s against the step's bound
    (6 N tokens over 67 TFLOP/s), peak memory and a ``profile_window`` over
    2 steps with the SSD kernels' shares of device time."""
    from repro_torch.configs import get
    from repro_torch.data import TokenPipeline
    from repro_torch.device import upload
    from repro_torch.launch import make_debug_mesh, make_train_step
    from repro_torch.models import build
    from repro_torch.train.optimizer import AdamWConfig, adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.train.tree import leaves

    resident = _free_card()
    cfg = dataclasses.replace(get(SSM_TRAIN_ARCH), dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    n_params = sum(p.numel() for p in leaves(params))
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=10, total_steps=steps)
    init, _ = adamw(opt_cfg)
    step_fn = make_train_step(cfg, make_debug_mesh(), TRAIN_BATCH, TRAIN_SEQ,
                              opt_cfg=opt_cfg).fn
    pipeline = TokenPipeline(vocab=cfg.vocab, batch=TRAIN_BATCH,
                             seq=TRAIN_SEQ)

    def to_device(b):
        return {k: upload(v, dev) for k, v in b.items()}

    tcfg = TrainerConfig(total_steps=steps, ckpt_every=10 ** 9,
                         log_every=10 ** 9)
    trainer = Trainer(step_fn, params, init(params), pipeline, tcfg,
                      to_device=to_device)
    trainer.ckpt.save = lambda *a, **kw: None
    torch.cuda.synchronize()
    _zero_ssd_launches()
    with PlainOnCard() as plain:
        t0 = time.perf_counter()
        hist = trainer.run()
        wall = time.perf_counter() - t0
    launches = _ssd_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9

    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    step_ms = [1e3 * h["time_s"] for h in hist]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    med = statistics.median(step_ms[1:])
    bound = 1e3 * 6 * n_params * tokens / PEAK_FLOPS["float32"]
    batch = to_device(pipeline.batch_at(steps))
    state = [trainer.params, trainer.opt_state]

    def one_step():
        state[0], state[1], _ = step_fn(state[0], state[1], batch)
    prof = profile_window("ssm_train_step", one_step, 2,
                          share_of=SSD_BWD_KERNELS + SSD_FWD_KERNELS)
    of = prof["device_ms_of"]
    for key, names in (("ssd_backward_share", SSD_BWD_KERNELS),
                       ("ssd_forward_share", SSD_FWD_KERNELS)):
        prof[key] = not_measured(
            None if None in of.values() else sum(of[k] for k in names),
            prof["device_busy_ms"])
    res = {"phase": "ssm_train", "model": cfg.name, "params": n_params,
           "dtype": cfg.dtype, "layers": cfg.n_layers, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": len(hist), "loss": losses,
           "grad_norm": norms, "lr": [h["lr"] for h in hist],
           "step_ms": step_ms, "step_ms_median": med,
           "tokens_per_s": tokens / (med / 1e3), "step_bound_ms": bound,
           "wall_s": wall, "launches": launches,
           "plain_calls_on_card": plain.calls, "peak_mem_gb": peak,
           "resident_before_gb": resident, "profile": prof}
    log(json.dumps(res))
    finite = all(math.isfinite(x) for x in losses + norms)
    check(len(hist) == steps, f"ssm train: {len(hist)} steps of {steps}")
    check(finite, f"ssm train: non-finite loss or grad norm {losses} "
          f"{norms}")
    check(losses[-1] < losses[0], f"ssm train: loss did not fall: {losses}")
    check(launches == {"ssd_scan": cfg.n_layers * steps,
                       "ssd_scan_backward": cfg.n_layers * steps},
          f"ssm train: launches {launches} vs {cfg.n_layers} a step")
    check(not any(plain.calls.values()),
          f"ssm train: plain versions ran on the card: {plain.calls}")
    check(peak < 80.0, f"ssm train: peak memory {peak} GB")
    return res, _trained(cfg, trainer.params, trainer.opt_state, med)


# -- the dry run against the card: its abstract state and its bound ----------

def phase_dryrun(dev, trained):
    """The dry run (``launch/dryrun.py``) against phases "train" and
    "ssm_train" (``trained``: their ``_trained`` records), on the 1 x 1
    mesh over the card. For each: the ``StepBundle``'s abstract arguments
    (meta) equal the trained parameters and optimizer state leaf for leaf
    in shape and dtype; ``sharded_size_bytes`` of them under the bundle's
    ``in_shardings`` equals the state's bytes on the card exactly;
    ``run_cell`` counts the step on meta (the kernels by their own work,
    the other ops as eager PyTorch runs them), and its bound
    max(compute_s, memory_s) against the H100's peaks (``dryrun.
    PEAK_FLOPS``, ``KERNEL_PEAK_FLOPS``, ``HBM_BW``) is at most the
    phase's measured median step: a bound above a measured step is a
    wrong count. Both phases must have run before it. Reports both times,
    their ratio, the plain versions' counts beside, the counted flops
    against 6 N D (``model_flops``) and the counting's host seconds."""
    from repro_torch.configs.registry import Shape
    from repro_torch.launch import dryrun, make_debug_mesh, make_train_step
    from repro_torch.launch.sharding import sharded_size_bytes
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.tree import leaves

    missing = sorted({"train", "ssm_train"} - set(trained))
    check(not missing, f"dryrun: phases {missing} must run before it")
    mesh = make_debug_mesh()
    res = {"phase": "dryrun", "mesh": repr(mesh),
           "peak_flops": dryrun.PEAK_FLOPS,
           "kernel_peak_flops": dryrun.KERNEL_PEAK_FLOPS,
           "hbm_bw": dryrun.HBM_BW}
    for name, rec in trained.items():
        cfg = rec["cfg"]
        bundle = make_train_step(cfg, mesh, TRAIN_BATCH, TRAIN_SEQ,
                                 opt_cfg=AdamWConfig(lr=TRAIN_LR))
        abstract = leaves(bundle.args[:2])
        same_leaves = [(tuple(t.shape), t.dtype) for t in abstract] \
            == rec["leaves"]
        arg_bytes = sharded_size_bytes(bundle.args[:2],
                                       bundle.in_shardings[:2])
        t = time.perf_counter()
        cell = dryrun.run_cell(cfg, Shape(name, "train", TRAIN_SEQ,
                                          TRAIN_BATCH), mesh, "1x1")
        count_s = time.perf_counter() - t
        bound_ms = 1e3 * max(cell.compute_s, cell.memory_s)
        step = rec["step_ms_median"]
        res[name] = {
            "model": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
            "leaves": len(abstract), "abstract_leaves_equal": same_leaves,
            "all_meta": all(t.device.type == "meta" for t in abstract),
            "state_devices": rec["devices"], "arg_bytes": arg_bytes,
            "state_bytes": rec["nbytes"],
            "arg_bytes_diff": arg_bytes - rec["nbytes"],
            "cell_arg_bytes": cell.arg_bytes_per_device,   # with the batch
            "flops": cell.per_device_flops, "bytes": cell.per_device_bytes,
            "kernel_flops": cell.memory["kernel_flops_global"],
            "flops_plain": cell.memory["flops_plain_global"],
            "bytes_plain": cell.memory["bytes_plain_global"],
            "model_flops_6nd": cell.model_flops,
            "flops_over_6nd": cell.per_device_flops / cell.model_flops,
            "compute_ms": 1e3 * cell.compute_s,
            "memory_ms": 1e3 * cell.memory_s, "bottleneck": cell.bottleneck,
            "bound_ms": bound_ms, "step_ms_median": step,
            "bound_over_step": bound_ms / step, "count_host_s": count_s}
        log(f"dryrun {name}: bound {bound_ms:.3f} ms ({cell.bottleneck}) "
            f"vs measured median step {step:.3f} ms, ratio "
            f"{bound_ms / step:.4f}")
        check(same_leaves and res[name]["all_meta"],
              f"dryrun {name}: abstract args differ from the trained state")
        check(rec["devices"] == [str(dev)],
              f"dryrun {name}: state on {rec['devices']}, mesh on {dev}")
        check(arg_bytes == rec["nbytes"], f"dryrun {name}: {arg_bytes} "
              f"arg bytes vs {rec['nbytes']} on the card")
        check(bound_ms <= step, f"dryrun {name}: bound {bound_ms} ms above "
              f"the measured step {step} ms: a wrong count")
    return res


# -- several devices: shard_rows and the mesh (ROADMAP item 31) --------------------

FLEET_SHARDS = (1, 2, 4)


def phase_fleet_shards(dev):
    """``shard_rows`` on the card: e6's two fleets (``SOLVE_FLEET``,
    ``SCALE_FLEET``) solved and e8's placement candidates
    (``_scale_candidates``) scored with each layout bucket's rows cut into
    1, 2 and 4 chunks, every chunk on the one card (``devices=[dev] * n``:
    the machine has one). Checks, for each count: assignments and scores
    byte-identical to the 1-shard solve; the RASK kernels' launches the
    buckets' non-empty chunks x (32 + 1) (32 backward, 1 forward a chunk);
    no plain version on the card; the card's scores held to the CPU twin's
    (the plain versions, the same uniforms) as "fleet_solve" holds them.
    Reports each count's median ms of 2 solves after the checked one, and
    the chunks a bucket. Where the machine has several cards, one more
    count: ``shard="auto"``, a chunk on each card, each solved with its
    card current, under the same checks."""
    import numpy as np

    from repro_torch.core.solver import (FleetSolverProblem,
                                         PlacementProblem, SolverProblem)
    from repro_torch.device import shard_devices

    cpu = torch.device("cpu")
    counts = [(str(n), [dev] * n) for n in FLEET_SHARDS]
    if torch.cuda.device_count() > 1:
        every = shard_devices("auto", dev)
        counts.append((f"{len(every)}_cards", every))
    res = {"phase": "fleet_shards", "shards": [k for k, _ in counts]}

    def over_counts(name, make, solve, cpu_twin, seed):
        rows, base = {}, None
        for n, devices in counts:
            prob = make(devices)
            if base is None:     # one draw for every count: alike buckets
                u = prob.uniforms(torch.Generator(dev).manual_seed(seed), 6)
                want_cpu = cpu_twin([x.cpu() for x in u])
            _zero_rask_counts()
            with PlainOnCard() as plain:
                out = solve(prob, u)
                torch.cuda.synchronize()
                launches = _rask_counts()
            chunks = sum(len(bk.shards) for bk in prob.buckets)
            base = out if base is None else base
            row = {"chunks": [len(bk.shards) for bk in prob.buckets],
                   "devices": sorted({str(w) for bk in prob.buckets
                                      for w, *_ in bk.shards}),
                   "launches": {"rask_objective": launches[0],
                                "rask_objective_grad": launches[1]},
                   "expected_launches": [chunks, 32 * chunks],
                   "plain_calls_on_card": plain.calls,
                   "byte_identical": all(np.array_equal(a, b)
                                         for a, b in zip(out, base)),
                   "score_rel_gap_cpu": _cpu_agreement(out[-1], want_cpu),
                   "ms": statistics.median(      # after the checked solve
                       _wall_ms(lambda: solve(prob, u))[0]
                       for _ in range(2))}
            rows[n] = row
            check(launches == (chunks, 32 * chunks),
                  f"fleet_shards {name} x{n}: launches {launches} for "
                  f"{chunks} chunks")
            check(not any(plain.calls.values()),
                  f"fleet_shards {name} x{n}: plain versions on the card")
            check(row["byte_identical"],
                  f"fleet_shards {name} x{n}: differs from 1 shard")
            _check_cpu_agreement(row["score_rel_gap_cpu"],
                                 f"fleet_shards {name} x{n}")
        res[name] = rows
        log(json.dumps({name: rows}))

    def cpu_models(sm):
        return type(sm)(sm.w.cpu(), sm.exponents.cpu(), sm.term_mask.cpu(),
                        sm.x_scale.cpu(), sm.max_degree)

    for name, fleet in (("hetero", SOLVE_FLEET), ("scale", SCALE_FLEET)):
        problem, host_of, caps, sm, rps, x0 = _solve_fleet(fleet, dev)
        on_cpu = SolverProblem(problem.specs, device=cpu)
        over_counts(name, lambda devs: FleetSolverProblem(
            problem, host_of, caps, devices=devs),
            lambda fp, u: fp.solve_many(sm, rps, x0, u=u),
            lambda u: FleetSolverProblem(on_cpu, host_of, caps).solve_many(
                cpu_models(sm), rps, x0, u=u)[1], seed=7)
    subsets, caps_list = _scale_candidates(problem, host_of, caps, x0)
    over_counts("placement", lambda devs: PlacementProblem(
        problem, subsets, caps_list, devices=devs),
        lambda pp, u: (pp.scores(sm, rps, x0, u=u),),
        lambda u: PlacementProblem(on_cpu, subsets, caps_list).scores(
            cpu_models(sm), rps, x0, u=u), seed=8)
    return res


MESH_ROWS, MESH_PROMPT, MESH_MAX_SEQ, MESH_DECODES = 4, 1024, 2048, 8
MESH_TRAIN_STEPS = 2
# whisper-large-v3: serving at full width and depth, 4 clips of
# 1,500 frames and an 8-token prompt, the bundles built with seq = 1,500
# frames; training in float32 cut to 8 + 8 layers (4 x 1,500 frames, 187
# tokens); gemma3-1b's mixed cache: 16 decode steps across its ring's
# wrap, from a one-device cache decoded to W - 8
MESH_ENCDEC_PROMPT, MESH_ENCDEC_TRAIN_LAYERS, MESH_MIXED_STEPS = 8, 8, 16
# a rank's local (rows, heads) of whisper's 4 clips x 20 heads on the
# (2, 2), (1, 4) and (4, 1) meshes
MESH_WHISPER_SHAPES = ((2, 10), (4, 5), (1, 20))
# the other families, full width cut in depth (PERF.md section 4):
# mamba2-370m 8 of 48 layers, 4 x 1,000 tokens; qwen2-moe-a2.7b 2 of 24
# layers, 4 x 512 (the 512 bucket); jamba at phase "hybrid_serve"'s
# one-period cut with 8 of its 16 experts (51.6 GB: the one-device steps
# run first, then the weights are placed leaf by leaf, each one-device
# leaf dropped as its DTensor takes its place), 4 x 1,000
MESH_SSM_LAYERS, MESH_SSM_PROMPT = 8, 1000
MESH_MOE_LAYERS, MESH_MOE_PROMPT = 2, 512
MESH_HYBRID_PROMPT = 1000
# bf16 serving: the mesh's one rank runs the one-device step's kernels on
# the same tensors, so tokens must be equal and logits and caches agree to
# bf16's rounding (tests/test_kernels.py's 5e-2); float32 training: loss
# and grad norm within 1e-4 relative, Adam's moments within 1e-4 of each
# leaf's largest entry (tests/test_torch_cuda.py's card-vs-CPU bars)
MESH_BF16_TOL, MESH_F32_REL = 5e-2, 1e-4


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _mesh_counts():
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_cuda)
    v = flash_attention_cuda.variant_launches
    return {"decode_attention": decode_attention_cuda.launches,
            "flash_wgmma": v["wgmma"], "flash_attention_fp32": v["tf32x3"],
            "flash_attention_backward": flash_attention_backward_cuda.launches,
            **_ssd_launches()}


def _zero_mesh_counts():
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import reset_launches
    decode_attention_cuda.launches = 0
    reset_launches()
    _zero_ssd_launches()


def _whole(t):
    """A DTensor's whole tensor (a plain tensor as it is)."""
    from repro_torch.models.spmd import is_dtensor
    return t.full_tensor() if is_dtensor(t) else t


def _wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def _place_dropping(tree, shardings):
    """``sharding.place(tree, shardings)`` leaf by leaf into ``tree``
    itself, each one-device leaf dropped as its DTensor takes its place:
    the card holds one tree and one leaf, not two trees (placing copies
    even on a (1, 1) mesh)."""
    from repro_torch.launch import sharding as SH
    for k in (tree if isinstance(tree, dict) else range(len(tree))):
        if isinstance(tree[k], (dict, list)):
            _place_dropping(tree[k], shardings[k])
        else:
            tree[k] = SH.place(tree[k], shardings[k])
    return tree


def _mesh_serve(dev, mesh, one, cfg, prompt_len, want, prefills=3,
                restore=False, frames=0):
    """``cfg`` (bf16) through the DTensor path: ``prefills`` prefills of
    ``MESH_ROWS`` x ``prompt_len`` tokens into a ``MESH_MAX_SEQ`` cache
    (an encoder-decoder: ``frames`` seeded frames a row too, the bundles
    built with seq = ``frames``, the cross cache's frames; the first
    prefill fills DTensor's caches, the rest are timed) and
    ``MESH_DECODES`` decode steps, against the one-device bundle steps on
    the same weights, run first: tokens equal, an MoE's kept routes at
    the first prefill equal, logits and every cache leaf within
    ``MESH_BF16_TOL``; the kernels' counts, zeroed just before the mesh
    run and read just after, equal to ``want(prefills)``; the placed
    weights' local bytes the dry run's; with ``restore`` the weights saved
    and restored onto the mesh bit for bit."""
    import tempfile

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build
    from repro_torch.models.moe import recording_routes
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.tree import leaves, map_tree

    model = build(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    max_seq = frames or MESH_MAX_SEQ
    pre1, dec1 = (make_prefill_step(cfg, one, MESH_ROWS, max_seq),
                  make_decode_step(cfg, one, MESH_ROWS, max_seq))
    pre, dec = (make_prefill_step(cfg, mesh, MESH_ROWS, max_seq),
                make_decode_step(cfg, mesh, MESH_ROWS, max_seq))
    gen = torch.Generator(dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (MESH_ROWS, prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": prompt}
    if frames:
        batch["frames"] = torch.randn(
            (MESH_ROWS, frames, cfg.d_model), generator=gen,
            device=dev).to(getattr(torch, cfg.dtype))
    res = {"model": cfg.name, "layers": cfg.n_layers,
           "encoder_layers": cfg.encoder_layers, "dtype": cfg.dtype,
           "n_experts": cfg.n_experts, "rows": MESH_ROWS,
           "prompt": prompt_len, "frames": frames, "max_seq": max_seq,
           "decode_steps": MESH_DECODES, "prefills": prefills,
           "weights_gb": _nbytes(params) / 1e9,
           "dryrun_bytes": SH.sharded_size_bytes(pre.args[0],
                                                 pre.in_shardings[0])}

    def run(step_pre, step_dec, p):
        ms = {"prefill": [], "decode": []}
        with recording_routes() as routes:
            t, (tok, cache) = _wall_ms(lambda: step_pre.fn(p, batch))
        kept = [(_whole(i), _whole(k)) for i, k in routes]
        ms["prefill"].append(t)
        for _ in range(prefills - 1):
            t, (tok, cache) = _wall_ms(lambda: step_pre.fn(p, batch))
            ms["prefill"].append(t)
        toks = [tok[:, None]]
        for _ in range(MESH_DECODES):
            t, (nxt, cache) = _wall_ms(lambda: step_dec.fn(p, toks[-1],
                                                           cache))
            ms["decode"].append(t)
            toks.append(nxt)
        return (torch.cat([_whole(t) for t in toks], dim=1),
                {k: _whole(v) for k, v in cache.items()
                 if v.is_floating_point()}, ms, kept)

    toks1, cache1, ms1, kept1 = run(pre1, dec1, params)
    with torch.no_grad():
        logits1 = model.prefill(params, batch, max_seq=max_seq)[0]
    before = torch.cuda.memory_allocated()
    placed = _place_dropping(params, pre.in_shardings[0])
    del params
    res["placing_allocated_gb"] = \
        (torch.cuda.memory_allocated() - before) / 1e9
    res["local_bytes"] = SH.local_bytes(placed)
    _zero_mesh_counts()
    gathered = kernel_ops.GATHERED_KV_BYTES
    gathered.update(dict.fromkeys(gathered, 0))
    with PlainOnCard() as plain:
        toks, cache, ms, kept = run(pre, dec, placed)
        torch.cuda.synchronize()
    launches = _mesh_counts()
    gathered = dict(gathered)
    with torch.no_grad():
        with implicit_replication():
            logits = model.prefill(placed, SH.place(
                batch, pre.in_shardings[1]), max_seq=max_seq)[0] \
                .full_tensor()
    res.update({
        "launches": launches, "plain_calls_on_card": plain.calls,
        "tokens_equal": bool(torch.equal(toks, toks1)),
        "moe_layers_routed": len(kept),
        "routes_equal": len(kept) == len(kept1) and all(
            torch.equal(a, b) for pair, pair1 in zip(kept, kept1)
            for a, b in zip(pair, pair1)),
        "routes_dropped": int(sum(int((~k).sum()) for _, k in kept)),
        "logits_max_abs_diff": float((logits.float() - logits1.float())
                                     .abs().max()),
        "cache_max_abs_diff": {k: float((v.float() - cache1[k].float())
                                        .abs().max())
                               for k, v in cache.items()},
        "prefill_ms": ms["prefill"], "prefill_ms_one_device": ms1["prefill"],
        "prefill_ms_median": statistics.median(ms["prefill"][1:]),
        "prefill_ms_median_one_device": statistics.median(
            ms1["prefill"][1:]),
        "decode_ms_median": statistics.median(ms["decode"][1:]),
        "decode_ms_median_one_device": statistics.median(ms1["decode"][1:]),
        "gathered_cache_bytes_a_step":     # counted; 0 where "model" is 1
            gathered["decode_attention"] / MESH_DECODES,
        "gathered_kv_bytes": gathered})
    name = f"mesh {cfg.name}"
    if restore:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = CheckpointManager(tmp)
            t = time.perf_counter()
            ckpt.save(0, placed, blocking=True)
            back = ckpt.restore(map_tree(torch.zeros_like, placed),
                                shardings=pre.in_shardings[0])
            torch.cuda.synchronize()
            res["restore_roundtrip_s"] = time.perf_counter() - t
        res["restored_bitwise"] = all(
            torch.equal(a.to_local(), b.to_local())
            and list(a.placements) == list(b.placements)
            and a.to_local().device == dev
            for a, b in zip(leaves(back), leaves(placed)))
        check(res["restored_bitwise"], f"{name}: restore is not bitwise")
    check(res["local_bytes"] == res["dryrun_bytes"],
          f"{name}: local bytes {res['local_bytes']} vs the dry run's "
          f"{res['dryrun_bytes']}")
    expected = want(prefills)
    check({k: launches[k] for k in expected} == expected,
          f"{name}: launches {launches}, want {expected}")
    check(not any(plain.calls.values()),
          f"{name}: plain versions on the card {plain.calls}")
    check(res["tokens_equal"], f"{name}: tokens differ from one device")
    check(res["routes_equal"], f"{name}: kept routes differ from one device")
    check(res["logits_max_abs_diff"] <= MESH_BF16_TOL
          and max(res["cache_max_abs_diff"].values()) <= MESH_BF16_TOL,
          f"{name}: logits {res['logits_max_abs_diff']}, cache "
          f"{res['cache_max_abs_diff']}")
    log(f"{name}: {json.dumps(res)}")
    return res


def _mesh_train(dev, mesh, one, cfg, want, seq=TRAIN_SEQ):
    """``cfg`` (float32): ``MESH_TRAIN_STEPS`` train steps of
    ``TRAIN_BATCH`` x ``seq`` tokens (an encoder-decoder: ``seq`` seeded
    frames and seq // 8 tokens a row) through the DTensor path against
    the one-device bundle step from the same weights and batches; the
    kernels' counts around the mesh run equal to ``want``."""
    from repro_torch.data import TokenPipeline
    from repro_torch.device import upload
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.models.model import ENCDEC_DEC_FRac
    from repro_torch.train.optimizer import AdamWConfig, adamw
    from repro_torch.train.tree import leaves, map_tree

    params = build(cfg).init(torch.Generator(dev).manual_seed(0))
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=10,
                          total_steps=TRAIN_STEPS)
    init, _ = adamw(opt_cfg)
    tr1 = make_train_step(cfg, one, TRAIN_BATCH, seq, opt_cfg=opt_cfg)
    tr = make_train_step(cfg, mesh, TRAIN_BATCH, seq, opt_cfg=opt_cfg)
    encdec = cfg.family == "encdec"
    pipe = TokenPipeline(vocab=cfg.vocab, batch=TRAIN_BATCH,
                         seq=seq // ENCDEC_DEC_FRac if encdec else seq)
    batches = [{k: upload(v, dev) for k, v in pipe.batch_at(i).items()}
               for i in range(MESH_TRAIN_STEPS)]
    gen = torch.Generator(dev).manual_seed(3)
    for b in batches if encdec else ():
        b["frames"] = torch.randn((TRAIN_BATCH, seq, cfg.d_model),
                                  generator=gen, device=dev)
    placed = [_place_dropping(map_tree(torch.clone, params),
                              tr.in_shardings[0])]
    placed.append(SH.place(init(placed[0]), tr.in_shardings[1]))
    placed_batch = SH.place(batches[0], tr.in_shardings[2])
    res = {"model": cfg.name, "layers": cfg.n_layers,
           "encoder_layers": cfg.encoder_layers, "dtype": cfg.dtype,
           "batch": TRAIN_BATCH, "seq": seq, "steps": MESH_TRAIN_STEPS,
           "local_bytes": SH.local_bytes((*placed, placed_batch)),
           "dryrun_bytes": SH.sharded_size_bytes(tr.args, tr.in_shardings)}
    del placed_batch

    def run(step, state):
        metrics, ms = [], []
        for b in batches:
            t, (p, o, m) = _wall_ms(lambda: step.fn(*state, b))
            state = [p, o]
            ms.append(t)
            metrics.append({k: float(_whole(v)) for k, v in m.items()})
        return state, metrics, ms

    _zero_mesh_counts()
    with PlainOnCard() as plain:
        state, metrics, ms = run(tr, placed)
        torch.cuda.synchronize()
    launches = _mesh_counts()
    mu = [t.full_tensor() for t in leaves(state[1].mu)]
    nu = [t.full_tensor() for t in leaves(state[1].nu)]
    del state, placed
    state1, metrics1, ms1 = run(tr1, [params, init(params)])

    def worst(got, want):
        return max(float((g - w).abs().max())
                   / max(float(w.abs().max()), 1e-9)
                   for g, w in zip(got, want))
    rel = {k: max(abs(m[k] - w[k]) / max(abs(w[k]), 1e-12)
                  for m, w in zip(metrics, metrics1))
           for k in ("loss", "grad_norm")}
    res.update({"launches": launches, "plain_calls_on_card": plain.calls,
                "loss": [m["loss"] for m in metrics],
                "loss_one_device": [m["loss"] for m in metrics1],
                "grad_norm": [m["grad_norm"] for m in metrics],
                "grad_norm_one_device": [m["grad_norm"] for m in metrics1],
                "metric_rel_diff": rel,
                "mu_rel_diff": worst(mu, leaves(state1[1].mu)),
                "nu_rel_diff": worst(nu, leaves(state1[1].nu)),
                "step_ms": ms, "step_ms_one_device": ms1})
    name = f"mesh train {cfg.name}"
    check(res["local_bytes"] == res["dryrun_bytes"],
          f"{name}: local bytes {res['local_bytes']} vs the dry run's "
          f"{res['dryrun_bytes']}")
    check({k: launches[k] for k in want} == want,
          f"{name}: launches {launches}, want {want}")
    check(not any(plain.calls.values()),
          f"{name}: plain versions on the card {plain.calls}")
    check(max(rel.values()) <= MESH_F32_REL
          and res["mu_rel_diff"] <= MESH_F32_REL
          and res["nu_rel_diff"] <= MESH_F32_REL,
          f"{name}: {rel}, mu {res['mu_rel_diff']}, nu "
          f"{res['nu_rel_diff']}")
    log(f"{name}: {json.dumps(res)}")
    return res


def _mesh_mixed(dev, mesh, one, cfg):
    """gemma3's mixed cache (bf16), which has no prefill: the one-device
    decode step runs ``MESH_ROWS`` rows greedily from ``init_cache`` to
    pos W - 8; a copy of that cache is placed on the mesh, and both run
    ``MESH_MIXED_STEPS`` steps from there, across the ring's wrap at W.
    Tokens equal, the mesh cache written in place (the bundle donates
    it), every cache leaf and one more step's logits within
    ``MESH_BF16_TOL``; the kernels' counts, zeroed just before the mesh
    steps and read just after, the decode kernel's once a layer a step."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import build
    from repro_torch.train.tree import map_tree

    model = build(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    dec1 = make_decode_step(cfg, one, MESH_ROWS, MESH_MAX_SEQ)
    dec = make_decode_step(cfg, mesh, MESH_ROWS, MESH_MAX_SEQ)
    start = cfg.window - MESH_MIXED_STEPS // 2
    cache1 = model.init_cache(MESH_ROWS, MESH_MAX_SEQ, dev)
    tok1 = torch.randint(0, cfg.vocab, (MESH_ROWS, 1), device=dev,
                         dtype=torch.int32,
                         generator=torch.Generator(dev).manual_seed(1))
    t0 = time.perf_counter()
    for _ in range(start):
        tok1, cache1 = dec1.fn(params, tok1, cache1)
    torch.cuda.synchronize()
    res = {"model": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "rows": MESH_ROWS, "window": cfg.window, "max_seq": MESH_MAX_SEQ,
           "from_pos": start, "decode_steps": MESH_MIXED_STEPS,
           "one_device_warm_s": time.perf_counter() - t0}
    placed = SH.place(params, dec.in_shardings[0])
    cache = SH.place(map_tree(torch.clone, cache1), dec.in_shardings[2])
    tok = SH.place(tok1, dec.in_shardings[1])
    res["local_bytes"] = SH.local_bytes((placed, cache))
    res["dryrun_bytes"] = SH.sharded_size_bytes(dec.args[::2],
                                                dec.in_shardings[::2])
    ms1, toks1 = [], []
    for _ in range(MESH_MIXED_STEPS):
        t, (tok1, cache1) = _wall_ms(lambda: dec1.fn(params, tok1, cache1))
        ms1.append(t)
        toks1.append(tok1)
    ms, toks, in_place = [], [], True
    _zero_mesh_counts()
    with PlainOnCard() as plain:
        for _ in range(MESH_MIXED_STEPS):
            t, (tok, new) = _wall_ms(lambda: dec.fn(placed, tok, cache))
            in_place &= all(new[k] is cache[k] and new[k].to_local()
                            .data_ptr() == cache[k].to_local().data_ptr()
                            for k in cache if k != "pos")
            cache = new
            ms.append(t)
            toks.append(tok)
        torch.cuda.synchronize()
    launches = _mesh_counts()
    with torch.no_grad():
        logits1 = model.decode(params, tok1, map_tree(torch.clone,
                                                      cache1))[0]
        with implicit_replication():
            logits = model.decode(placed, tok, map_tree(
                torch.clone, cache))[0].full_tensor()
    toks = torch.cat([_whole(t) for t in toks], dim=1)
    res.update({
        "launches": launches, "plain_calls_on_card": plain.calls,
        "tokens_equal": bool(torch.equal(toks, torch.cat(toks1, dim=1))),
        "cache_in_place": in_place,
        "pos": _whole(cache["pos"]).tolist(),
        "logits_max_abs_diff": float((logits.float() - logits1.float())
                                     .abs().max()),
        "cache_max_abs_diff": {
            k: float((_whole(v).float() - cache1[k].float()).abs().max())
            for k, v in cache.items() if v.is_floating_point()},
        "decode_ms": ms, "decode_ms_one_device": ms1,
        "decode_ms_median": statistics.median(ms[1:]),
        "decode_ms_median_one_device": statistics.median(ms1[1:])})
    name = f"mesh mixed {cfg.name}"
    want = {"decode_attention": cfg.n_layers * MESH_MIXED_STEPS,
            "flash_wgmma": 0}
    check(res["local_bytes"] == res["dryrun_bytes"],
          f"{name}: local bytes {res['local_bytes']} vs the dry run's "
          f"{res['dryrun_bytes']}")
    check({k: launches[k] for k in want} == want,
          f"{name}: launches {launches}, want {want}")
    check(not any(plain.calls.values()),
          f"{name}: plain versions on the card {plain.calls}")
    check(res["pos"] == [start + MESH_MIXED_STEPS] * MESH_ROWS
          and res["pos"][0] > cfg.window, f"{name}: cursors {res['pos']}")
    check(res["tokens_equal"], f"{name}: tokens differ from one device")
    check(in_place, f"{name}: the cache was not written in place")
    check(res["logits_max_abs_diff"] <= MESH_BF16_TOL
          and max(res["cache_max_abs_diff"].values()) <= MESH_BF16_TOL,
          f"{name}: logits {res['logits_max_abs_diff']}, cache "
          f"{res['cache_max_abs_diff']}")
    log(f"{name}: {json.dumps(res)}")
    return res


def phase_mesh(dev):
    """The step bundles on a real ``torch.distributed`` mesh: a one-rank
    ``nccl`` world on the card (``tcp://localhost``, a free port),
    ``make_debug_mesh()`` its (1, 1) mesh, every step's tensors DTensors
    placed by the bundle's shardings, each held to the one-device bundle
    step on the same inputs (``_mesh_serve``, ``_mesh_train``) with its
    launch counts zeroed just before the mesh run and read just after and
    its placed state's local bytes the dry run's per-device bytes.
    "serve": gemma3-1b's bf16 prefill and decode steps (the weights also
    restored onto the mesh bit for bit); "train": its float32 train step;
    "ssm_serve", "ssm_train": mamba2-370m's (the SSD scan's forward and
    backward kernels under ``local_map``); "moe_serve": qwen2-moe-a2.7b's
    (its kept routes equal); "hybrid_serve": jamba's period (attention,
    the SSD scan, the MoE); "encdec_serve", "encdec_train": whisper's
    (the non-causal flash kernel and its backward under ``local_map``,
    the decode kernel over the cross cache); "mixed_decode": gemma3's
    mixed ring cache across its wrap (``_mesh_mixed``)."""
    import torch.distributed as dist

    from repro_torch.configs import get
    from repro_torch.launch.mesh import Mesh, make_debug_mesh

    gemma = dataclasses.replace(get("gemma3-1b"), n_layers=PERIOD_LAYERS)
    ssm = dataclasses.replace(get(SSM_TRAIN_ARCH), n_layers=MESH_SSM_LAYERS)
    moe = dataclasses.replace(get(MOE_ARCH), n_layers=MESH_MOE_LAYERS)
    jamba = _jamba_cut()
    whisper = get(WHISPER_ARCH)
    n_attn, n_mamba, _ = _hybrid_counts(jamba)

    def attention(n):          # n attention layers: flash, decode
        return lambda prefills: {"flash_wgmma": prefills * n,
                                 "decode_attention": n * MESH_DECODES}
    _free_card()
    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_debug_mesh()
        one = Mesh((1, 1), ("data", "model"), [dev])
        check(mesh.distributed and mesh.device == dev,
              f"mesh: {mesh!r} on {mesh.device}")
        res = {"phase": "mesh", "backend": dist.get_backend(),
               "mesh": repr(mesh)}
        res["serve"] = _mesh_serve(dev, mesh, one, gemma, MESH_PROMPT,
                                   attention(gemma.n_layers),
                                   restore=True)
        _free_card()
        n = PERIOD_LAYERS * MESH_TRAIN_STEPS
        res["train"] = _mesh_train(
            dev, mesh, one, dataclasses.replace(gemma, dtype="float32"),
            {"flash_attention_fp32": n, "flash_attention_backward": n})
        _free_card()
        res["ssm_serve"] = _mesh_serve(
            dev, mesh, one, ssm, MESH_SSM_PROMPT,
            lambda prefills: {"ssd_scan": prefills * ssm.n_layers,
                              "flash_wgmma": 0, "decode_attention": 0})
        _free_card()
        n = MESH_SSM_LAYERS * MESH_TRAIN_STEPS
        res["ssm_train"] = _mesh_train(
            dev, mesh, one, dataclasses.replace(ssm, dtype="float32"),
            {"ssd_scan": n, "ssd_scan_backward": n})
        _free_card()
        res["moe_serve"] = _mesh_serve(
            dev, mesh, one, moe, MESH_MOE_PROMPT,
            attention(moe.n_layers))
        check(res["moe_serve"]["moe_layers_routed"] == moe.n_layers,
              f"mesh moe: {res['moe_serve']['moe_layers_routed']} layers "
              "routed")
        _free_card()
        hybrid = attention(n_attn)
        res["hybrid_serve"] = _mesh_serve(
            dev, mesh, one, jamba, MESH_HYBRID_PROMPT,
            lambda prefills: dict(hybrid(prefills),
                                  ssd_scan=prefills * n_mamba))
        _free_card()
        # whisper: flash for each encoder layer and twice a decoder layer
        # (its causal prompt, its cross-attention), the decode kernel
        # twice a decoder layer (self and cross)
        n_flash = whisper.encoder_layers + 2 * whisper.n_layers
        res["encdec_serve"] = _mesh_serve(
            dev, mesh, one, whisper, MESH_ENCDEC_PROMPT,
            lambda prefills: {"flash_wgmma": prefills * n_flash,
                              "decode_attention":
                                  2 * whisper.n_layers * MESH_DECODES},
            frames=WHISPER_FRAMES)
        _free_card()
        cut = dataclasses.replace(
            whisper, n_layers=MESH_ENCDEC_TRAIN_LAYERS,
            encoder_layers=MESH_ENCDEC_TRAIN_LAYERS, dtype="float32")
        n = (cut.encoder_layers + 2 * cut.n_layers) * MESH_TRAIN_STEPS
        res["encdec_train"] = _mesh_train(
            dev, mesh, one, cut,
            {"flash_attention_fp32": n, "flash_attention_backward": n},
            seq=WHISPER_FRAMES)
        _free_card()
        res["mixed_decode"] = _mesh_mixed(dev, mesh, one,
                                          gemma_period(mixed_cache=True))
    finally:
        dist.destroy_process_group()
    _free_card()
    log(json.dumps(res))
    return res


# -- the summary ------------------------------------------------------------------

def emit(phase, *args, **kw):
    """Run ``phase``, print its result (the first item where it returns
    several) as one JSON line with its wall ``seconds``, return what it
    returned."""
    t = time.perf_counter()
    out = phase(*args, **kw)
    res = out[0] if isinstance(out, tuple) else out
    res["seconds"] = time.perf_counter() - t
    print(json.dumps(res), flush=True)
    return out


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


def backward_entry(rows, launches):
    """The ``kernels`` entry of the attention backward: timed on gemma3-1b's
    local layer in float32 (the training step's), with its tensor-core
    bound, its CTAs a pass and its CUDA kernels a call (the plan's 3 or
    4), and every other case and dtype beside it."""
    entry = kernel_entry(rows, "flash_attention_backward", "gemma_w512",
                         launches, BWD_SOURCE, "src/repro/kernels/ref.py:300",
                         dtype="float32")
    rep = next(r for r in rows if (r["case"], r["dtype"])
                == ("gemma_w512", "float32"))
    entry["max_rel_err"] = max(r["max_rel_err"] for r in rows
                               if r["dtype"] == "float32")
    entry["bound_tf32x3_ms"] = rep["bound_tf32x3"][0]
    for key in ("kernels_per_call", "dkdv_ctas", "dq_ctas"):
        entry[key] = rep[key]
    for r in rows:
        if (r["case"], r["dtype"]) != ("gemma_w512", "float32"):
            entry[f"{r['case']}_{r['dtype']}"] = {
                k: r[k] for k in ("ms", "call_ms", "plain_ms", "library_ms",
                                  "max_abs_err", "max_rel_err", "fwd_ms",
                                  "fwd_lse_ms", "fwd_plain_ms",
                                  "fwd_library_ms", "kernels_per_call",
                                  "dkdv_ctas", "dq_ctas")} | {
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1]} | (
                {"bound_tf32x3_ms": r["bound_tf32x3"][0]}
                if "bound_tf32x3" in r else {})
    return entry


def ssd_backward_entry(rows, launches):
    """The ``kernels`` entry of the SSD backward: timed on mamba2-370m's
    training shape in float32 (the training step's), with its CUDA kernels
    a call and each one's device ms there, the forward kernel's time at the
    same shape, and every other case and dtype beside it."""
    entry = kernel_entry(rows, "ssd_scan_backward", "mamba2_b4_l1024",
                         launches, SSD_BWD_SOURCE,
                         "src/repro/kernels/ref.py:72 (jax.vjp of "
                         "ssd_reference)", dtype="float32")
    rep = next(r for r in rows if (r["case"], r["dtype"])
               == ("mamba2_b4_l1024", "float32"))
    entry["max_rel_err"] = max(r["max_rel_err"] for r in rows
                               if r["dtype"] == "float32")
    for key in ("kernels_per_call", "device_ms_of", "fwd_ms",
                "fwd_plain_ms", "fwd_bound", "plan", "variant", "capacity",
                "partitions", "partials_bytes"):
        entry[key] = rep[key]
    entry["bound_tf32x3_ms"], entry["bound_tf32x3_by"] = rep["bound_tf32x3"]
    for r in rows:
        if (r["case"], r["dtype"]) != ("mamba2_b4_l1024", "float32"):
            entry[f"{r['case']}_{r['dtype']}"] = {
                k: r[k] for k in ("ms", "call_ms", "plain_ms", "library_ms",
                                  "max_abs_err", "max_rel_err", "fwd_ms",
                                  "kernels_per_call", "plan")} | {
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
    return entry


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the full report (JSON) here")
    ap.add_argument("--phases", help="after the build, run only these of "
                    "the training phases (comma-separated: train_kernels, "
                    "train_crosscheck, train, ssd_backward_kernels, "
                    "ssm_train_crosscheck, ssm_train, dryrun: after train "
                    "and ssm_train; fleet_shards, mesh; ssd_kernels, "
                    "kernels) and print no summary")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

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
    if args.phases:
        training = {"train_kernels": phase_train_kernels,
                    "train_crosscheck": phase_train_crosscheck,
                    "train": phase_train,
                    "ssd_backward_kernels": phase_ssd_backward_kernels,
                    "ssm_train_crosscheck": phase_ssm_train_crosscheck,
                    "ssm_train": phase_ssm_train}
        trained = {}
        for name in args.phases.split(","):
            if name == "dryrun":
                emit(phase_dryrun, dev, trained)
                continue
            if name in ("fleet_shards", "mesh", "ssd_kernels", "kernels"):
                emit({"fleet_shards": phase_fleet_shards,
                      "mesh": phase_mesh,
                      "ssd_kernels": phase_ssd_kernels,
                      "kernels": lambda d: {"phase": "kernels",
                                            "cases": phase_kernels(d)}
                      }[name], dev)
                continue
            out = emit(training[name], dev)
            if name in ("train", "ssm_train"):
                trained[name] = out[1]
        return 0

    t = time.perf_counter()
    rows = phase_kernels(dev)
    print(json.dumps({"phase": "kernels", "cases": rows,
                      "seconds": time.perf_counter() - t}), flush=True)
    cross = emit(phase_crosscheck, dev)
    serve, engine = emit(phase_serve, dev)
    trace = emit(phase_trace, engine)
    del engine

    timing, agents = emit(phase_decide_timing, dev)
    rask_kernels = emit(phase_rask_kernels, dev, agents)
    auto, auto_env, auto_agent = emit(phase_autoscale, dev)
    rask_cross = emit(phase_rask_crosscheck, auto_env, auto_agent)
    rask_trace = emit(phase_rask_trace, auto_env, auto_agent)

    ssd_kernels = emit(phase_ssd_kernels, dev)
    ssm_cross = emit(phase_ssm_crosscheck, dev)
    ssm_serve, ssm_engine = emit(phase_ssm_serve, dev)
    ssm_trace = emit(phase_trace, ssm_engine, name="ssm_trace")
    del ssm_engine

    engine_compare = emit(phase_engine_compare, dev)
    loop = emit(phase_serving_loop, dev)
    loop_launches = {k: loop["fixed"]["launches"][k]
                     + loop["rask"]["launches"][k]
                     for k in loop["rask"]["launches"]}

    fleet_solve, fleet_keep = emit(phase_fleet_solve, dev)
    failover, _, failover_agent = emit(phase_failover, dev)
    fleet_kernels = emit(phase_fleet_kernels, dev, fleet_keep, failover_agent)
    del fleet_keep, failover_agent
    fleet_launches = {k: sum(fleet_solve[p]["launches"][k]
                             for p in ("hetero", "scale", "placement"))
                      for k in ("rask_objective", "rask_objective_grad")}

    pipeline = emit(phase_pipeline, dev)
    forecast = emit(phase_forecast, dev)
    transfer = emit(phase_transfer, dev)
    burn = emit(phase_burn_budget, dev)
    backends = emit(phase_backends, dev)
    auto_degree, auto_agent = emit(phase_auto_degree, dev)
    k1 = emit(phase_rask_kernels_k1, dev, agents, auto_agent)
    del auto_agent
    sota, (sota_env, sota_agent) = emit(phase_sota, dev)
    metrics = emit(phase_metrics, dev, sota_env, sota_agent)
    del sota_env, sota_agent

    moe_cross = emit(phase_moe_crosscheck, dev)
    moe_serve, moe_engine = emit(phase_moe_serve, dev)
    moe_trace = emit(phase_moe_trace, moe_engine)
    del moe_engine
    autoscale_cli = emit(phase_autoscale_cli, dev)
    fleet_launchers = emit(phase_fleet_launchers, dev)

    encdec_cross = emit(phase_encdec_crosscheck, dev)
    encdec_serve, whisper = emit(phase_encdec_serve, dev)
    encdec_trace = emit(phase_encdec_trace, *whisper)
    del whisper
    mixed = emit(phase_mixed_cache, dev)
    hybrid_cross = emit(phase_hybrid_crosscheck, dev)
    hybrid_serve, hybrid_engine = emit(phase_hybrid_serve, dev)
    hybrid_trace = emit(phase_hybrid_trace, hybrid_engine)
    del hybrid_engine

    train_kernels = emit(phase_train_kernels, dev)
    train_cross = emit(phase_train_crosscheck, dev)
    train, trained = emit(phase_train, dev)
    ssd_backward = emit(phase_ssd_backward_kernels, dev)
    ssm_train_cross = emit(phase_ssm_train_crosscheck, dev)
    ssm_train, ssm_trained = emit(phase_ssm_train, dev)
    dry = emit(phase_dryrun, dev, {"train": trained,
                                   "ssm_train": ssm_trained})
    del trained, ssm_trained
    fleet_shards = emit(phase_fleet_shards, dev)
    mesh = emit(phase_mesh, dev)
    mesh_launches = {k: sum(mesh[p]["launches"][k] for p in (
        "serve", "train", "ssm_serve", "ssm_train", "moe_serve",
        "hybrid_serve", "encdec_serve", "encdec_train", "mixed_decode"))
        for k in mesh["serve"]["launches"]}
    shard_launches = {k: sum(fleet_shards[p][n]["launches"][k]
                             for p in ("hetero", "scale", "placement")
                             for n in fleet_shards[p])
                      for k in ("rask_objective", "rask_objective_grad")}
    option_launches = {
        "pipeline": {k: sum(pipeline[m]["launches"][k]
                            for m in ("sync", "pipelined"))
                     for k in ("rask_objective", "rask_objective_grad")},
        "forecast": {k: sum(forecast[t][m]["launches"][k]
                            for t in ("bursty", "diurnal")
                            for m in ("reactive", "forecast"))
                     for k in ("rask_objective", "rask_objective_grad")},
        "transfer": transfer["launches"], "burn_budget": burn["launches"],
        "backends": backends["launches"],
        "auto_degree": auto_degree["launches"], "sota": sota["launches"],
        **{f"autoscale_cli_{m}": autoscale_cli[f"{m}_cuda"]["launches"]
           for m in ("default", "fleet")},
        **{f"fleet_launchers_{m}": fleet_launchers[m]["launches"]
           for m in ("fleet_autoscale", "hetero_fleet")}}

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
                     "src/repro/kernels/ssd_scan.py:79"),
        # the training slice: a local layer of gemma3-1b's step (22 of 26)
        backward_entry(train_kernels["cases"],
                       train["launches"]["flash_attention_backward"]),
        # mamba2-370m's training step, float32
        ssd_backward_entry(ssd_backward["cases"],
                           ssm_train["launches"]["ssd_scan_backward"])]}
    # each kernel's launches on every path that ran it: "launches" above is
    # its own slice's serving or autoscale phase
    compare = [engine_compare[k][f"{e}_launches"] for k in engine_compare
               if k.startswith("slots=") for e in ("dict", "stacked")]
    by_phase = {
        "decode_attention": {"serve": serve["launches"]["decode_attention"],
                             "engine_compare": sum(
                                 c["decode_attention"] for c in compare),
                             "serving_loop":
                                 loop_launches["decode_attention"],
                             "moe_serve":
                                 moe_serve["launches"]["decode_attention"],
                             "moe_crosscheck": moe_cross["decode_launches"],
                             "encdec_serve":
                                 encdec_serve["launches"]["decode_attention"],
                             "encdec_crosscheck":
                                 encdec_cross["decode_launches"],
                             "mixed_cache":
                                 mixed["launches"]["decode_attention"],
                             "hybrid_serve":
                                 hybrid_serve["launches"]["decode_attention"],
                             "hybrid_crosscheck":
                                 hybrid_cross["decode_launches"],
                             "mesh": mesh_launches["decode_attention"]},
        "flash_attention": {"serve": serve["flash_variant_launches"]["wgmma"],
                            "engine_compare": sum(c["wgmma"]
                                                  for c in compare),
                            "serving_loop": loop_launches["flash_wgmma"],
                            "moe_serve":
                                moe_serve["flash_variant_launches"]["wgmma"],
                            "encdec_serve":
                                encdec_serve["launches"]["flash_wgmma"],
                            "hybrid_serve":
                                hybrid_serve["launches"]["flash_wgmma"],
                            "mesh": mesh_launches["flash_wgmma"]},
        "flash_attention_fp32": {
            "crosscheck": cross["flash_launches"]["tf32x3"],
            "moe_crosscheck": moe_cross["flash_launches"]["tf32x3"],
            "encdec_crosscheck": encdec_cross["flash_launches"]["tf32x3"],
            "hybrid_crosscheck": hybrid_cross["flash_launches"]["tf32x3"],
            "train": train["launches"]["flash_attention_fp32"],
            "train_crosscheck":
                train_cross["launches"]["flash_attention_fp32"],
            "mesh": mesh_launches["flash_attention_fp32"]},
        "flash_attention_backward": {
            "train": train["launches"]["flash_attention_backward"],
            "mesh": mesh_launches["flash_attention_backward"],
            "train_crosscheck":
                train_cross["launches"]["flash_attention_backward"],
            "ssm_train_crosscheck": ssm_train_cross["jamba"]["launches"][
                "flash_attention_backward"]},
        "ssd_scan": {"ssm_serve": ssm_serve["launches"]["ssd_scan"],
                     "hybrid_serve": hybrid_serve["launches"]["ssd_scan"],
                     "hybrid_crosscheck": hybrid_cross["ssd_launches"],
                     "ssm_train": ssm_train["launches"]["ssd_scan"],
                     "ssm_train_crosscheck": sum(
                         ssm_train_cross[m]["launches"]["ssd_scan"]
                         for m in ("mamba2", "jamba")),
                     "mesh": mesh_launches["ssd_scan"]},
        "ssd_scan_backward": {
            "ssm_train": ssm_train["launches"]["ssd_scan_backward"],
            "mesh": mesh_launches["ssd_scan_backward"],
            "ssm_train_crosscheck": sum(
                ssm_train_cross[m]["launches"]["ssd_scan_backward"]
                for m in ("mamba2", "jamba"))},
        "rask_objective": {"autoscale": auto["launches"]["rask_objective"],
                           "serving_loop": loop_launches["rask_objective"],
                           "fleet_solve": fleet_launches["rask_objective"],
                           "failover":
                               failover["launches"]["rask_objective"],
                           "fleet_shards": shard_launches["rask_objective"],
                           **{p: v["rask_objective"]
                              for p, v in option_launches.items()}},
        "rask_objective_grad": {
            "autoscale": auto["launches"]["rask_objective_grad"],
            "serving_loop": loop_launches["rask_objective_grad"],
            "fleet_solve": fleet_launches["rask_objective_grad"],
            "failover": failover["launches"]["rask_objective_grad"],
            "fleet_shards": shard_launches["rask_objective_grad"],
            **{p: v["rask_objective_grad"]
               for p, v in option_launches.items()}}}
    # and their times at e11's shapes, qwen2-moe's, whisper's, the mixed
    # ring's and jamba's (attention and the SSD scan in bf16, the float32
    # flash kernel at the cross-checks' shapes; the RASK kernels on the
    # loop's own agent, whose errors count in the entry's worst)
    e11_cases = {"decode_attention": ("e11_stacked", "e11_dict", "moe",
                                      "whisper_self", "whisper_cross",
                                      "mixed_ring", "jamba",
                                      *(f"whisper_cross_r{b}h{h}"
                                        for b, h in MESH_WHISPER_SHAPES)),
                 "flash_attention": ("e11_S13", "e11_S32", "moe_S128",
                                     "moe_S512", "moe_S1024", "whisper_enc",
                                     "whisper_xattn", "whisper_prompt",
                                     "jamba_S300", "jamba_S1000",
                                     *(f"whisper_enc_r{b}h{h}"
                                       for b, h in MESH_WHISPER_SHAPES[:2])),
                 "flash_attention_fp32": ("whisper_enc", "whisper_xattn",
                                          "jamba_S300"),
                 "ssd_scan": ("h256_b1_l384", "h256_b1_l1024",
                              *(f"h{h}_b{b}_l{l}"
                                for b, l, _, h in MESH_SSD_SHAPES))}
    e11_rows = [r for r in rows + ssd_kernels["cases"]
                if r["dtype"] == "bfloat16"] + loop["rask_kernels"] + [
        dict(r, kernel="flash_attention_fp32") for r in rows
        if r["kernel"] == "flash_attention" and r["dtype"] == "float32"]
    for r in loop["rask_kernels"]:
        e11_cases.setdefault(r["kernel"], (r["case"],))
    for entry in kernels["kernels"]:
        if entry["name"] in by_phase:
            entry["launches_by_phase"] = by_phase[entry["name"]]
        for case in e11_cases.get(entry["name"], ()):
            rep = next(r for r in e11_rows if r["kernel"] == entry["name"]
                       and r["case"] == case)
            entry[case] = {k: rep[k] for k in ("ms", "call_ms", "plain_ms",
                                               "library_ms", "max_abs_err",
                                               "ctas") if k in rep}
            entry[case]["bound_ms"], entry[case]["bound_by"] = rep["bound"]
            if entry["name"].startswith("rask"):
                entry["max_abs_err"] = max(entry["max_abs_err"],
                                           rep["max_abs_err"])
    # the batched cases (one launch a layout bucket): their times beside
    # the per-row loop, and their errors in the entry's worst
    for entry in kernels["kernels"]:
        extra = [r for r in fleet_kernels["cases"]
                 if r["kernel"] == entry["name"]]
        if not extra:
            continue
        entry["batched"] = {
            r["case"]: {k: r[k] for k in (
                "rows", "K", "ctas", "ms", "call_ms", "plain_ms",
                "per_row_loop_ms", "library_ms", "max_abs_err")}
            | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
            for r in extra}
        entry["max_abs_err"] = max([entry["max_abs_err"]]
                                   + [r["max_abs_err"] for r in extra])
    # the adaptive budget's shapes (K = 2 and 3; batches at K = 2) on the
    # burn_budget agent's tables: times beside, errors in the worst
    for entry in kernels["kernels"]:
        extra = [r for r in burn["kernel_cases"]
                 if r["kernel"] == entry["name"]]
        if not extra:
            continue
        entry["adapt_budget"] = {
            r["case"]: {k: r[k] for k in ("K", "ms", "call_ms", "plain_ms",
                                          "library_ms", "max_abs_err")}
            | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
            for r in extra}
        entry["max_abs_err"] = max([entry["max_abs_err"]]
                                   + [r["max_abs_err"] for r in extra])
    # one candidate (K = 1: an SLSQP evaluation) and the auto-degree tables
    # (T = 84, mixed degrees): times beside, errors in the worst
    for entry in kernels["kernels"]:
        extra = [r for r in k1["cases"] if r["kernel"] == entry["name"]]
        if not extra:
            continue
        entry["k1_and_auto_degree"] = {
            r["case"]: {k: r[k] for k in ("K", "terms", "ms", "call_ms",
                                          "plain_ms", "library_ms",
                                          "max_abs_err")}
            | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
            for r in extra}
        entry["max_abs_err"] = max([entry["max_abs_err"]]
                                   + [r["max_abs_err"] for r in extra])
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
             "ssm_trace": ssm_trace, "engine_compare": engine_compare,
             "serving_loop": loop, "fleet_solve": fleet_solve,
             "failover": failover, "fleet_kernels": fleet_kernels,
             "pipeline": pipeline, "forecast": forecast,
             "transfer": transfer, "burn_budget": burn,
             "backends": backends, "auto_degree": auto_degree,
             "rask_kernels_k1": k1, "sota": sota, "metrics": metrics,
             "moe_crosscheck": moe_cross, "moe_serve": moe_serve,
             "moe_trace": moe_trace, "autoscale_cli": autoscale_cli,
             "fleet_launchers": fleet_launchers,
             "encdec_crosscheck": encdec_cross, "encdec_serve": encdec_serve,
             "encdec_trace": encdec_trace, "mixed_cache": mixed,
             "hybrid_crosscheck": hybrid_cross, "hybrid_serve": hybrid_serve,
             "hybrid_trace": hybrid_trace, "train_kernels": train_kernels,
             "train_crosscheck": train_cross, "train": train,
             "ssd_backward_kernels": ssd_backward,
             "ssm_train_crosscheck": ssm_train_cross, "ssm_train": ssm_train,
             "dryrun": dry, "fleet_shards": fleet_shards, "mesh": mesh,
             "wall_s": time.perf_counter() - t_start, **kernels},
            indent=1))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
