"""Shared by ``tests/test_torch_mesh_dist.py`` (the dense decoder),
``tests/test_torch_mesh_families.py`` (the ssm program, the MoE decoder and
the hybrid) and ``tests/test_torch_mesh_encdec.py`` (the encoder-decoder
and gemma3's mixed cache): configs' step bundles on a real
``torch.distributed`` mesh, a 4-rank ``gloo`` world on the CPU meshed
(2, 2), (4, 1) and (1, 4) in turn, each config's smoke cut in float32
(vocab 64; whisper's 66), against the port's one-device steps and
``repro``'s jitted one-device train step on the same weights (``repro``'s
init, carried across by ``models/convert.py``; whisper's zero biases and
unit LayerNorm scales replaced by seeded draws, so that a bias added once
a rank would show).

On each mesh every rank places the weights by the bundles' shardings
(``launch/sharding.py::place``) and runs, as DTensors:

* the prefill step (4 rows of 24 tokens into a 48-slot cache; whisper: 4
  clips of 64 frames and an 8-token prompt, the bundles built with seq =
  64 frames), its logits (``Model.prefill`` on the placed weights) and,
  for an MoE, its kept routes (``moe.recording_routes``); a mixed cache
  has no prefill: its prefill step's ``ValueError``;
* three decode steps (a mixed cache: 20 from a placed ``init_cache``,
  past one wrap of its 16-slot ring), each writing into the cache it was
  given (the same tensors and local storage come back: the bundle
  donates the cache), and the bytes each rank received to gather
  attention's kv (``kernels/ops.py::GATHERED_KV_BYTES``);
* one train step (4 x 32 tokens; whisper: 4 x 64 frames and 8 tokens),
  one compressed train step (``compressed_grads=True``) and one step of
  two microbatches, each from the same weights;
* the state's local shapes and bytes and the cache's local bytes, and a
  save from rank 0 restored onto the mesh;
* a config's own ``extras`` entries.

The bars: tokens equal; prefill logits and caches within 1e-5 of their
largest entry (the sharded products sum in another order); loss and grad
norm within 1e-5 relative of the one-device step's (and ``repro``'s); the
first moment within 1e-4 of each leaf's largest entry (1e-9 floor) of
both, the second of the one-device step's (1e-12 floor); the compressed
step's loss and grad norm within 1e-5 relative, its error feedback within
1e-3 of each leaf's largest entry (1e-9 floor) but for at most one entry
in 10,000 (a code that rounds the other way); the microbatched step's
loss, grad norm and aux within 1e-5 relative, its first moment as above;
routes identical; local bytes equal to ``sharded_size_bytes``; the
restore bitwise.

One world runs every config of a test file (``spawn`` start method, a
``FileStore`` under the test's temp dir, one thread a rank); the parent
computes the references while the ranks run, and joins them with a time
limit, counted from the spawn, that kills the ranks and fails the test.
"""
import dataclasses
import time
from typing import Any, Dict

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get
from repro_torch.kernels import ops as kernel_ops
from repro_torch.data import TokenPipeline
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import build
from repro_torch.models.model import ENCDEC_DEC_FRac
from repro_torch.models.moe import recording_routes
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig, adamw, compressed_adamw
from repro_torch.train.tree import leaves, map_tree
from torch_weights import perturbed

MESHES = [(2, 2), (4, 1), (1, 4)]
B, S, PROMPT, MAX_SEQ, DECODES = 4, 32, 24, 48, 3
OCFG = dict(lr=5e-3, warmup_steps=2, total_steps=20)
VOCAB = 64
# whisper's vocab: 66 % 4 = 2, as 51,866 % 4 = 2, so that a "model" axis
# of 4 leaves the table whole over "model" (the embed rule's fallback)
VOCABS = {"whisper-large-v3": 66}
# whisper's clips and prompt; a mixed cache's decode steps (W = 16)
FRAMES, ENCDEC_PROMPT, MIXED_DECODES = 64, 8, 20
TRAIN_KINDS = ("plain", "compressed", "micro")
MIXED = "-mixed"           # an arch's suffix: its config with mixed_cache


def smoke(arch, get=get):
    """``arch``'s smoke cut in float32 (``get``: the port's configs or
    ``repro``'s); ``<arch>-mixed`` is ``arch`` with ``mixed_cache``."""
    base = arch.removesuffix(MIXED)
    return dataclasses.replace(get(base).smoke(), dtype="float32",
                               remat="none", vocab=VOCABS.get(base, VOCAB),
                               mixed_cache=arch != base)


def _full(t):
    """A whole copy of ``t`` (a DTensor's gathered; steps write in place)."""
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).clone()


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _prefill(cfg, mesh, pre, params, batch, max_seq):
    """The prefill step's tokens, cache and routes, and its logits."""
    from torch.distributed.tensor.experimental import implicit_replication
    out = {}
    with recording_routes() as routes:
        tok, cache = pre.fn(params, batch)
    out["routes"] = [(_full(i), _full(k)) for i, k in routes]
    out["prefill_tok"] = _full(tok)
    out["prefill_cache"] = {k: _full(v) for k, v in cache.items()}
    batch = {k: v.to(mesh.device) for k, v in batch.items()}
    with torch.no_grad():
        if mesh.distributed:
            batch = SH.place(batch, pre.in_shardings[1])
            with implicit_replication():
                logits, _ = build(cfg).prefill(params, batch,
                                               max_seq=max_seq)
        else:
            logits, _ = build(cfg).prefill(params, batch, max_seq=max_seq)
    out["prefill_logits"] = _full(logits)
    return out, tok, cache


def _serve(cfg, mesh, params, inp):
    """Prefill tokens, logits, cache and routes, then ``inp["decodes"]``
    greedy steps (whether each wrote into the cache it was given). A
    mixed cache: its prefill step's error, then the decode steps from a
    placed ``init_cache`` and the prompt's first tokens."""
    max_seq = inp["max_seq"]
    pre = make_prefill_step(cfg, mesh, B, max_seq)
    dec = make_decode_step(cfg, mesh, B, max_seq)
    if mesh.distributed:
        params = SH.place(params, pre.in_shardings[0])
    batch = {"tokens": inp["prompt"]}
    if "frames" in inp:
        batch["frames"] = inp["frames"]
    if cfg.mixed_cache:
        with pytest.raises(ValueError) as raised:
            pre.fn(params, batch)
        out = {"prefill_raises": str(raised.value), "routes": []}
        cache = build(cfg).init_cache(B, max_seq, mesh.device)
        if mesh.distributed:
            cache = SH.place(cache, dec.in_shardings[2])
        first = inp["prompt"][:, :1]
    else:
        out, tok, cache = _prefill(cfg, mesh, pre, params, batch, max_seq)
        first = _full(tok)[:, None]
    toks, in_place = [first], True
    gathered = kernel_ops.GATHERED_KV_BYTES
    gathered.update(dict.fromkeys(gathered, 0))
    for _ in range(inp["decodes"]):
        nxt, new = dec.fn(params, toks[-1], cache)
        in_place &= all(new[k] is cache[k] and _local(new[k]).data_ptr()
                        == _local(cache[k]).data_ptr()
                        for k in cache if k != "pos")
        cache = new
        toks.append(_full(nxt))
    out["decode_in_place"] = in_place
    out["decode_gathered_bytes"] = gathered["decode_attention"]
    out["decode_tok"] = torch.cat(toks[1:], dim=1)
    out["decode_cache"] = {k: _full(v) for k, v in cache.items()}
    out["cache_bytes"] = (SH.local_bytes(cache), SH.sharded_size_bytes(
        dec.args[2], dec.in_shardings[2]))
    return out


def _train(cfg, mesh, params, batch, seq, kinds=TRAIN_KINDS):
    """From ``params``: of ``kinds``, one train step ("plain"), one
    compressed train step and one step of two microbatches, built for
    ``seq``."""
    out = {}
    for kind in kinds:
        ocfg = AdamWConfig(**OCFG)
        comp, micro = kind == "compressed", 2 if kind == "micro" else 1
        init = (compressed_adamw if comp else adamw)(ocfg)[0]
        tr = make_train_step(cfg, mesh, B, seq, opt_cfg=ocfg,
                             compressed_grads=comp, microbatches=micro)
        p = map_tree(torch.clone, params)
        o = init(p)
        if mesh.distributed:
            p, o = SH.place(p, tr.in_shardings[0]), \
                SH.place(o, tr.in_shardings[1])
        b = {k: v.reshape((micro, B // micro) + tuple(v.shape[1:]))
             if micro > 1 else v for k, v in batch.items()}
        p2, o2, m = tr.fn(p, o, b)
        metrics = {k: float(_full(v)) for k, v in m.items()}
        if comp:
            out["c_metrics"] = metrics
            out["c_error"] = [_full(t) for t in leaves(o2.error)]
        elif micro > 1:
            out["m_metrics"] = metrics
            out["m_mu"] = [_full(t) for t in leaves(o2.mu)]
        else:
            out["donated"] = all(a is b for a, b in zip(
                leaves((p2, o2.mu, o2.nu)), leaves((p, o.mu, o.nu))))
            out["metrics"] = metrics
            out["mu"] = [_full(t) for t in leaves(o2.mu)]
            out["nu"] = [_full(t) for t in leaves(o2.nu)]
            state, bundle = (p2, o2), tr
    return out, state, bundle


def run_steps(cfg, mesh, inp):
    """Every result of one mesh (or of one device)."""
    res = _serve(cfg, mesh, map_tree(torch.clone, inp["params"]), inp)
    trained, state, tr = _train(cfg, mesh, inp["params"], inp["batch"],
                                inp["seq"], inp["train"])
    res.update(trained)
    return res, state, tr


def _on_mesh(shape, out_dir, arch, inp, extra, device):
    cfg = smoke(arch)
    mesh = make_debug_mesh(*shape, device=device)
    res, state, tr = run_steps(cfg, mesh, inp)
    res["local_shapes"] = [tuple(t.to_local().shape) for t in leaves(state)]
    res["state_bytes"] = (SH.local_bytes(state), SH.sharded_size_bytes(
        tr.args[:2], tr.in_shardings[:2]))
    tag = f"{arch}_{shape[0]}x{shape[1]}"
    ckpt = CheckpointManager(f"{out_dir}/ckpt_{tag}")
    ckpt.save(1, state, blocking=True)
    back = ckpt.restore(map_tree(torch.zeros_like, state),
                        shardings=tr.in_shardings[:2])
    res["restored_bitwise"] = all(
        torch.equal(a.to_local(), b.to_local())
        and list(a.placements) == list(b.placements)
        for a, b in zip(leaves(back), leaves(state)))
    if extra is not None:
        res.update(extra(cfg, mesh, inp))
    return res


def _cpu(tree):
    """Results with their tensors on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _result(out_dir, rank, arch, shape):
    return f"{out_dir}/rank{rank}_{arch}_{shape[0]}x{shape[1]}.pt"


def _world(rank, store, out_dir, inps, extras, backend):
    """One rank of the 4-rank world: every mesh in turn, and on each every
    config of ``inps`` (arch -> inputs). A ``gloo`` rank runs on the CPU,
    an ``nccl`` one on card ``rank``."""
    torch.set_num_threads(1)
    device = "cpu" if backend == "gloo" else None
    if backend == "nccl":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    try:
        for shape in MESHES:
            for arch, inp in inps.items():
                torch.save(_cpu(_on_mesh(shape, out_dir, arch, inp,
                                         extras.get(arch), device)),
                           _result(out_dir, rank, arch, shape))
    finally:
        dist.destroy_process_group()


def join(ctx, deadline):
    """Join the spawned ranks by ``deadline`` (``time.monotonic()``), or
    kill them and fail the test."""
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the 4-rank world did not finish in its time")


def spawn(tmp, inps, join_s, extras=None, backend="gloo",
          meanwhile=lambda: None):
    """The 4-rank world's results, ``{(arch, mesh shape): [rank 0..3]}``,
    for the configs of ``inps`` (arch -> inputs), ``extras[arch](cfg,
    mesh, inp)`` adding a rank's own entries on each mesh; and what
    ``meanwhile()`` returns, run here while the ranks run. The ranks have
    ``join_s`` seconds from their spawn."""
    deadline = time.monotonic() + join_s
    ctx = mp.start_processes(
        _world, args=(str(tmp / "store"), str(tmp), inps, extras or {},
                      backend),
        nprocs=4, join=False, start_method="spawn")
    try:
        done = meanwhile()
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    join(ctx, deadline)
    return {(arch, shape): [torch.load(_result(tmp, r, arch, shape),
                                       weights_only=False)
                            for r in range(4)]
            for arch in inps for shape in MESHES}, done


def _repro_routes(jcfg, jmodel, jp, prompt):
    """``repro``'s top-k choices at prefill, (T, k) a MoE layer in call
    order, recorded from inside its jitted program."""
    import jax
    import jax.numpy as jnp

    import repro.models.transformer as jt
    got, moe = [], jt.moe

    def recording(p, x, cfg, **kw):
        T = x.shape[0] * x.shape[1]
        probs = jax.nn.softmax(x.reshape(T, -1).astype(jnp.float32)
                               @ p["router"], axis=-1)
        jax.debug.callback(lambda i: got.append(np.asarray(i)),
                           jax.lax.top_k(probs, cfg.top_k)[1], ordered=True)
        return moe(p, x, cfg, **kw)
    jt.moe = recording
    try:
        jax.block_until_ready(jax.jit(
            lambda p, t: jmodel.prefill(p, {"tokens": t}, MAX_SEQ))(
                jp, jnp.asarray(np.array(prompt.numpy()))))
        jax.effects_barrier()
    finally:
        jt.moe = moe
    return got


def inputs(params, cfg) -> Dict[str, Any]:
    """The steps' inputs: ``params``, a train batch of B x S tokens and
    its first PROMPT tokens as the prompt, the bundles' ``seq`` (train)
    and ``max_seq`` (serve), the decode steps and the train steps' kinds.
    The encoder-decoder: B clips of FRAMES frames from a numpy seed, a
    batch of FRAMES // 8 tokens, the prompt its first ENCDEC_PROMPT, every
    bundle built with FRAMES. A mixed cache decodes MIXED_DECODES steps
    and trains the plain step only: ``mixed_cache`` changes the decode
    cache alone, so its train steps are its base config's, whose
    compressed and microbatched steps its own world runs."""
    seq = FRAMES if cfg.family == "encdec" else S
    tokens = seq // ENCDEC_DEC_FRac if cfg.family == "encdec" else seq
    batch = {k: torch.from_numpy(v) for k, v in TokenPipeline(
        vocab=cfg.vocab, batch=B, seq=tokens).batch_at(1).items()}
    inp = dict(params=params, batch=batch, seq=seq, max_seq=MAX_SEQ,
               decodes=MIXED_DECODES if cfg.mixed_cache else DECODES,
               train=TRAIN_KINDS[:1] if cfg.mixed_cache else TRAIN_KINDS,
               prompt=batch["tokens"][:, :PROMPT].contiguous())
    if cfg.family == "encdec":
        batch["frames"] = inp["frames"] = torch.from_numpy(
            np.random.default_rng(3).normal(
                size=(B, FRAMES, cfg.d_model)).astype(np.float32))
        inp.update(max_seq=FRAMES,
                   prompt=batch["tokens"][:, :ENCDEC_PROMPT].contiguous())
    return inp


def repro_init(arch):
    """``repro``'s initial weights for ``arch``'s smoke cut (whisper's
    ``perturbed``), and the steps' inputs on them (``inp``, the port's
    weights)."""
    import jax

    from repro.configs import get as jax_get
    from repro.models import build as jax_build
    from repro_torch.models.convert import params_from_numpy

    cfg, jcfg = smoke(arch), smoke(arch, jax_get)
    jmodel = jax_build(jcfg)
    tree = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0)))
    if cfg.family == "encdec":
        tree = perturbed(tree, np.random.default_rng(1))
    inp = inputs(params_from_numpy(cfg, tree), cfg)
    # copies: ``spawn`` moves the inputs' storage into shared memory, and
    # a JAX array on the CPU may alias the buffer it was made from
    return dict(cfg=cfg, jcfg=jcfg, jmodel=jmodel, inp=inp,
                jp=jax.tree.map(jax.numpy.asarray, tree),
                jbatch={k: jax.numpy.asarray(np.array(v.numpy()))
                        for k, v in inp["batch"].items()})


def _repro_tokens(init):
    """``repro``'s greedy tokens on the steps' inputs: its jitted prefill's
    and decode steps' (a mixed cache: decode steps from ``init_cache``
    and the prompt's first tokens)."""
    import jax
    import jax.numpy as jnp

    jmodel, jp, inp = init["jmodel"], init["jp"], init["inp"]
    decode = jax.jit(jmodel.decode)
    out = {}
    if init["cfg"].mixed_cache:
        cache = jmodel.init_cache(B, inp["max_seq"])
        tok = jnp.asarray(np.array(inp["prompt"][:, :1].numpy()), jnp.int32)
    else:
        batch = {"tokens": jnp.asarray(np.array(inp["prompt"].numpy()))}
        if "frames" in inp:
            batch["frames"] = jnp.asarray(np.array(inp["frames"].numpy()))
        logits, cache = jax.jit(lambda p, b: jmodel.prefill(
            p, b, inp["max_seq"]))(jp, batch)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        out["jax_prefill_tok"] = torch.from_numpy(np.array(tok[:, 0]))
    toks = []
    for _ in range(inp["decodes"]):
        logits, cache = decode(jp, tok, cache)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
    out["jax_decode_tok"] = torch.from_numpy(np.concatenate(toks, axis=1))
    return out


def reference(init, routes=False, extra=None, tokens=False):
    """``repro``'s jitted one-device train step's metrics and first moment
    (and, with ``routes``, its prefill's top-k choices; with ``tokens``,
    its prefill's and decode steps' tokens) from ``init`` (``repro_init``),
    and the port's one-device steps (and ``extra``'s entries) on the same
    inputs."""
    import jax

    from repro.launch import make_debug_mesh as jax_mesh
    from repro.launch import make_train_step as jax_make_train_step
    from repro.train import optimizer as jopt
    from repro_torch.models.convert import params_from_numpy

    cfg, inp, jp = init["cfg"], init["inp"], init["jp"]
    ocfg = jopt.AdamWConfig(**OCFG)
    bundle = jax_make_train_step(init["jcfg"], jax_mesh(1, 1), batch=B,
                                 seq=inp["seq"], opt_cfg=ocfg)
    _, js, jm = jax.jit(bundle.fn)(jp, jopt.adamw(ocfg)[0](jp),
                                   init["jbatch"])
    out = dict(cfg=cfg, inp=inp,
               jax_metrics={k: float(v) for k, v in jm.items()},
               jax_mu=leaves(params_from_numpy(
                   cfg, jax.tree.map(np.asarray, js.mu))))
    if routes:
        out["jax_routes"] = _repro_routes(init["jcfg"], init["jmodel"], jp,
                                          inp["prompt"])
    if tokens:
        out.update(_repro_tokens(init))
    one = make_debug_mesh(device="cpu")
    out["one"] = run_steps(cfg, one, inp)[0]
    if extra is not None:
        out["one"].update(extra(cfg, one, inp))
    return out


# -- the bars -----------------------------------------------------------------

def near(got, want, rel):
    return float((got - want).abs().max()) <= rel * max(
        float(want.abs().max()), 1e-30)


def check_prefill(res, one):
    """Tokens, logits and cache; a mixed cache's prefill error."""
    if "prefill_raises" in one:
        assert res["prefill_raises"] == one["prefill_raises"]
        return
    assert torch.equal(res["prefill_tok"], one["prefill_tok"])
    assert near(res["prefill_logits"], one["prefill_logits"], 1e-5)
    for key, want in one["prefill_cache"].items():
        got = res["prefill_cache"][key]
        if want.is_floating_point():
            assert near(got, want, 1e-5), key
        else:
            assert torch.equal(got, want), key


def check_decode(ranks, one):
    for res in ranks:
        assert res["decode_in_place"]
        assert torch.equal(res["decode_tok"], one["decode_tok"])
        assert torch.equal(res["decode_cache"]["pos"],
                           one["decode_cache"]["pos"])
    for key, want in one["decode_cache"].items():
        if want.is_floating_point():
            assert near(ranks[0]["decode_cache"][key], want, 1e-5), key


def check_train(res, one, ref=None):
    """Against the one-device step and, with ``ref``, ``repro``'s."""
    assert res["donated"]
    for want in (one["metrics"], ref and ref["jax_metrics"]):
        for key in ("loss", "grad_norm"):
            assert want is None or abs(res["metrics"][key] - want[key]) \
                <= 1e-5 * abs(want[key]), (key, res["metrics"], want)
    for want in (one["mu"], ref and ref["jax_mu"]):
        if want is None:
            continue
        for g, w in zip(res["mu"], want, strict=True):
            assert float((g - w).abs().max()) <= max(
                1e-4 * float(w.abs().max()), 1e-9)
    for g, w in zip(res["nu"], one["nu"], strict=True):
        assert float((g - w).abs().max()) <= max(
            1e-4 * float(w.abs().max()), 1e-12)


def check_compressed(res, one, ref=None):
    """The error feedback within 1e-3 of each leaf's largest entry, with
    the 1e-9 floor of ``check_train``'s first moment: a key projection's
    bias has a gradient of 0 (it shifts all of a row's logits alike,
    which softmax ignores), so whisper's hold rounding noise of ~1e-11 on
    both sides."""
    for want, keys in ((one["c_metrics"], ("loss", "grad_norm")),
                       (ref and ref["jax_metrics"], ("loss",))):
        for key in keys if want else ():
            assert abs(res["c_metrics"][key] - want[key]) \
                <= 1e-5 * abs(want[key]), key
    far = sum(int(((g - w).abs() > max(1e-3 * float(w.abs().max()),
                                       1e-9)).sum())
              for g, w in zip(res["c_error"], one["c_error"], strict=True))
    total = sum(w.numel() for w in one["c_error"])
    assert far <= total // 10_000, (far, total)


def check_microbatched(res, one):
    """Two microbatches: loss, grad norm and aux (the MoE's load-balancing
    loss, summed over the microbatches on DTensors) within 1e-5 relative,
    the first moment within 1e-4 of each leaf's largest entry."""
    for key in ("loss", "grad_norm", "aux"):
        want = one["m_metrics"][key]
        assert abs(res["m_metrics"][key] - want) <= 1e-5 * abs(want), key
    for g, w in zip(res["m_mu"], one["m_mu"], strict=True):
        assert float((g - w).abs().max()) <= max(
            1e-4 * float(w.abs().max()), 1e-9)


def check_bytes(ranks):
    for res in ranks:
        for key in ("state_bytes", "cache_bytes"):
            got, want = res[key]
            assert got == want, key


def check_routes(ranks, one):
    for res in ranks:
        assert len(res["routes"]) == len(one["routes"])
        for (idx, keep), (widx, wkeep) in zip(res["routes"], one["routes"]):
            assert torch.equal(idx, widx) and torch.equal(keep, wkeep)
