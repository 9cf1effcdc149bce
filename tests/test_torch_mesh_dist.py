"""The dense decoder's step bundles on a real ``torch.distributed`` mesh:
a 4-rank ``gloo`` world on the CPU, meshed (2, 2), (4, 1) and (1, 4) in
turn, gemma3-1b's smoke cut in float32 (4 query heads on one kv
head, d_head 16: "model" would cut the kv head, as at full width).

Each mesh places ``repro``'s initial weights by the bundles' shardings
(``launch/sharding.py::place``) and runs the prefill step (4 rows of 24
tokens into a 48-slot cache), three decode steps and one train step
(4 x 32 tokens) as DTensors; rank 0 writes the results whole. Against
the port's one-device steps on the same inputs:

* prefill and decode tokens are equal; the prefill logits and the caches
  agree within 1e-5 of their largest entry (float32; the sharded products
  sum in another order);
* the train step's loss and grad norm agree within 1e-5 relative, its
  moments within 1e-4 of each leaf's largest entry (or 1e-9; 1e-12 for
  the second moment), with the one-device step and, for the loss, grad
  norm and first moment, with ``repro``'s one-device jitted step
  (``tests/test_torch_train.py``'s tolerances for a step; the parameters
  are not compared after it: Adam's first step is ~lr x sign(g));
* one AdamW update from ``repro``'s gradients (identical on every mesh):
  parameters within 1e-6 absolute, moments within 1e-6 of each leaf's
  largest entry, against ``repro``'s update (``test_torch_train.py``'s
  one-update tolerance);
* the compressed train step (``compressed_grads=True``): loss and grad
  norm within 1e-5 relative of the one-device step's (the loss also of
  ``repro``'s), the error feedback within 1e-3 of each leaf's largest entry but for codes
  that round the other way (at most one entry in 10,000); one compressed
  update from ``repro``'s state after a compressed update and its next
  gradient: parameters, moments, error feedback and grad norm at the
  tolerances above, against ``repro``'s update and the one-device one
  (each stack's int8 scale is taken over the whole leaf);
* a decode step gathers each layer's cache over "model": every rank
  receives (model - 1) / model of its rows' k and v, counted by
  ``kernels/ops.py::GATHERED_KV_BYTES`` (0 on one device);
* every rank's local shapes are the specs' split of the global shapes, and
  its local bytes equal ``sharded_size_bytes`` (the dry run's per-device
  bytes); the saved state restored onto the mesh equals each rank's shards
  bit for bit;
* an ssm and an MoE config raise on the 4-rank mesh, naming ROADMAP item
  32.

One 4-rank world is spawned for the three meshes (``spawn`` start method,
``FileStore`` under the test's temp dir, one thread a rank) and joined
with a 120 s limit that kills the ranks and fails the test.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get
from repro_torch.data import TokenPipeline
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import Mesh, make_debug_mesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import build
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.kernels import ops as kernel_ops
from repro_torch.train.optimizer import AdamWConfig, adamw, compressed_adamw
from repro_torch.train.tree import leaves, map_tree

torch.set_num_threads(1)
MESHES = [(2, 2), (4, 1), (1, 4)]
B, S, PROMPT, MAX_SEQ, DECODES = 4, 32, 24, 48, 3
OCFG = dict(lr=5e-3, warmup_steps=2, total_steps=20)
JOIN_S = 120


def _cfg():
    return dataclasses.replace(get("gemma3-1b").smoke(), dtype="float32",
                               remat="none", vocab=64)


def _inputs(params):
    batch = {k: torch.from_numpy(v) for k, v in TokenPipeline(
        vocab=64, batch=B, seq=S).batch_at(1).items()}
    return dict(params=params, batch=batch,
                prompt=batch["tokens"][:, :PROMPT].contiguous())


def _full(t):
    """A whole copy (the decode steps write their cache in place)."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t.clone()


def _serve(cfg, mesh, params, prompt):
    """Prefill tokens, logits and cache, then DECODES greedy steps."""
    from torch.distributed.tensor.experimental import implicit_replication
    pre = make_prefill_step(cfg, mesh, B, MAX_SEQ)
    dec = make_decode_step(cfg, mesh, B, MAX_SEQ)
    out = {}
    tok, cache = pre.fn(params, {"tokens": prompt})
    out["prefill_tok"] = _full(tok)
    out["prefill_k"] = _full(cache["k"])
    batch = {"tokens": prompt}
    if mesh.distributed:
        batch = SH.place(batch, pre.in_shardings[1])
        with implicit_replication():
            logits, _ = build(cfg).prefill(params, batch, max_seq=MAX_SEQ)
    else:
        logits, _ = build(cfg).prefill(params, batch, max_seq=MAX_SEQ)
    out["prefill_logits"] = _full(logits)
    toks = [_full(tok)[:, None]]
    gathered = kernel_ops.GATHERED_KV_BYTES
    gathered.update(dict.fromkeys(gathered, 0))
    for _ in range(DECODES):
        nxt, cache = dec.fn(params, toks[-1], cache)
        toks.append(_full(nxt))
    out["decode_gathered_bytes"] = gathered["decode_attention"]
    out["decode_tok"] = torch.cat(toks[1:], dim=1)
    out["decode_k"], out["decode_v"] = _full(cache["k"]), _full(cache["v"])
    out["decode_pos"] = _full(cache["pos"])
    return out


def _train(cfg, mesh, params, batch, grads, comp):
    """One train step, and one update from ``grads``, both from
    ``params``; the same compressed (``_compressed``)."""
    init, update = adamw(AdamWConfig(**OCFG))
    tr = make_train_step(cfg, mesh, B, S, opt_cfg=AdamWConfig(**OCFG))
    p_sh, o_sh = tr.in_shardings[:2]

    def state():
        p = map_tree(torch.clone, params)
        o = init(p)
        if mesh.distributed:
            p, o = SH.place(p, p_sh), SH.place(o, o_sh)
        return p, o
    out = {}
    p, o = state()
    p2, o2, m = tr.fn(p, o, batch)
    out["donated"] = all(a is b for a, b in zip(
        leaves((p2, o2.mu, o2.nu)), leaves((p, o.mu, o.nu))))
    out["metrics"] = {k: float(_full(v)) for k, v in m.items()}
    out["mu"] = [_full(t) for t in leaves(o2.mu)]
    out["nu"] = [_full(t) for t in leaves(o2.nu)]
    p, o = state()
    g = SH.place(grads, p_sh) if mesh.distributed else grads
    p3, o3, m3 = update(g, o, p)
    out["upd_params"] = [_full(t) for t in leaves(p3)]
    out["upd_mu"] = [_full(t) for t in leaves(o3.mu)]
    out["upd_nu"] = [_full(t) for t in leaves(o3.nu)]
    out["upd_grad_norm"] = float(_full(m3["grad_norm"]))
    out.update(_compressed(cfg, mesh, params, batch, comp))
    return out, (p2, o2), tr


def _compressed(cfg, mesh, params, batch, comp):
    """One compressed train step from ``params``, and one compressed update
    from ``repro``'s state after a compressed update (its error feedback
    not zero) with ``repro``'s next gradient (``comp``)."""
    init, update = compressed_adamw(AdamWConfig(**OCFG))
    tr = make_train_step(cfg, mesh, B, S, opt_cfg=AdamWConfig(**OCFG),
                         compressed_grads=True)
    p_sh, o_sh = tr.in_shardings[:2]

    def placed(p, o):
        return (SH.place(p, p_sh), SH.place(o, o_sh)) if mesh.distributed \
            else (p, o)
    out = {}
    p, o = placed(map_tree(torch.clone, params), init(params))
    _, o2, m = tr.fn(p, o, batch)
    out["c_metrics"] = {k: float(_full(v)) for k, v in m.items()}
    out["c_mu"] = [_full(t) for t in leaves(o2.inner.mu)]
    out["c_error"] = [_full(t) for t in leaves(o2.error)]
    p, o = placed(map_tree(torch.clone, comp["params"]),
                  map_tree(torch.clone, comp["state"]))
    g = SH.place(comp["grads"], p_sh) if mesh.distributed else comp["grads"]
    p3, o3, m3 = update(g, o, p)
    out["c_upd_params"] = [_full(t) for t in leaves(p3)]
    out["c_upd_mu"] = [_full(t) for t in leaves(o3.inner.mu)]
    out["c_upd_nu"] = [_full(t) for t in leaves(o3.inner.nu)]
    out["c_upd_error"] = [_full(t) for t in leaves(o3.error)]
    out["c_upd_grad_norm"] = float(_full(m3["grad_norm"]))
    return out


def _on_mesh(shape, out_dir, inp):
    cfg = _cfg()
    mesh = make_debug_mesh(*shape, device="cpu")
    res = _serve(cfg, mesh, SH.place(
        map_tree(torch.clone, inp["params"]),
        make_prefill_step(cfg, mesh, B, MAX_SEQ).in_shardings[0]),
        inp["prompt"])
    trained, state, tr = _train(cfg, mesh, inp["params"], inp["batch"],
                                inp["grads"], inp["compressed"])
    res.update(trained)
    res["local_shapes"] = [tuple(t.to_local().shape) for t in leaves(state)]
    res["local_bytes"] = SH.local_bytes(state)
    res["want_bytes"] = SH.sharded_size_bytes(tr.args[:2],
                                              tr.in_shardings[:2])
    ckpt = CheckpointManager(f"{out_dir}/ckpt{shape[0]}x{shape[1]}")
    ckpt.save(1, state, blocking=True)
    back = ckpt.restore(map_tree(torch.zeros_like, state),
                        shardings=tr.in_shardings[:2])
    res["restored_bitwise"] = all(
        torch.equal(a.to_local(), b.to_local())
        and list(a.placements) == list(b.placements)
        for a, b in zip(leaves(back), leaves(state)))
    res["raises"] = {}
    for arch, make in (("mamba2-370m", make_train_step),
                       ("qwen2-moe-a2.7b", make_decode_step)):
        try:
            make(get(arch).smoke(), mesh, B, S)
        except NotImplementedError as e:
            res["raises"][arch] = str(e)
    return res


def _world(rank, store, out_dir, inp):
    """One rank of the 4-rank world: every mesh in turn."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    try:
        for shape in MESHES:
            torch.save(_on_mesh(shape, out_dir, inp),
                       f"{out_dir}/rank{rank}_{shape[0]}x{shape[1]}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(tmp, inp):
    ctx = mp.start_processes(_world, args=(str(tmp / "store"), str(tmp),
                                           inp),
                             nprocs=4, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the 4-rank world did not finish in {JOIN_S} s")
    return {shape: [torch.load(tmp / f"rank{r}_{shape[0]}x{shape[1]}.pt",
                               weights_only=False) for r in range(4)]
            for shape in MESHES}


@pytest.fixture(scope="module")
def reference():
    """``repro``'s initial weights, its gradient there, its one-device
    jitted train step and its update from that gradient; the port's
    one-device steps on the same inputs."""
    import jax

    from repro.configs import get as jax_get
    from repro.launch import make_debug_mesh as jax_mesh
    from repro.launch import make_train_step as jax_make_train_step
    from repro.models import build as jax_build
    from repro.train import optimizer as jopt
    from repro_torch.models.convert import opt_state_from_numpy, \
        params_from_numpy

    cfg = _cfg()
    jcfg = dataclasses.replace(jax_get("gemma3-1b").smoke(),
                               dtype="float32", remat="none", vocab=64)
    tree = jax.tree.map(np.asarray, jax.jit(jax_build(jcfg).init)(
        jax.random.PRNGKey(0)))
    params = params_from_numpy(cfg, tree)
    inp = _inputs(params)
    jbatch = {k: jax.numpy.asarray(v.numpy())
              for k, v in inp["batch"].items()}
    jp = jax.tree.map(jax.numpy.asarray, tree)
    jmodel = jax_build(jcfg)
    grad = jax.jit(jax.grad(lambda p: jmodel.loss(p, jbatch)[0]))
    jgrads = grad(jp)
    jinit, jupdate = jopt.adamw(jopt.AdamWConfig(**OCFG))
    jup = jax.jit(jupdate)(jgrads, jinit(jp), jp)
    bundle = jax_make_train_step(jcfg, jax_mesh(1, 1), batch=B, seq=S,
                                 opt_cfg=jopt.AdamWConfig(**OCFG))
    _, js, jm = jax.jit(bundle.fn)(jp, jinit(jp), jbatch)
    # compressed: repro's update after one compressed update
    jcinit, jcupdate = jopt.compressed_adamw(jopt.AdamWConfig(**OCFG))
    jcupdate = jax.jit(jcupdate)
    jp1, js1, _ = jcupdate(jgrads, jcinit(jp), jp)
    jg1 = grad(jp1)
    jcup = jcupdate(jg1, js1, jp1)

    def np_(t):
        return jax.tree.map(np.asarray, t)

    def port(t):
        return leaves(params_from_numpy(cfg, np_(t)))
    inp["grads"] = params_from_numpy(cfg, np_(jgrads))
    inp["compressed"] = dict(params=params_from_numpy(cfg, np_(jp1)),
                             state=opt_state_from_numpy(cfg, np_(js1)),
                             grads=params_from_numpy(cfg, np_(jg1)))
    cpu = make_debug_mesh(device="cpu")
    one = _serve(cfg, cpu, params, inp["prompt"])
    one.update(_train(cfg, cpu, params, inp["batch"], inp["grads"],
                      inp["compressed"])[0])
    return dict(cfg=cfg, inp=inp, one=one, jax_metrics={
        k: float(v) for k, v in jm.items()}, jax_mu=port(js.mu),
        jax_upd=dict(params=port(jup[0]), mu=port(jup[1].mu),
                     nu=port(jup[1].nu), grad_norm=float(
                         jup[2]["grad_norm"])),
        jax_c_upd=dict(params=port(jcup[0]), mu=port(jcup[1].inner.mu),
                       nu=port(jcup[1].inner.nu),
                       error=port(jcup[1].error),
                       grad_norm=float(jcup[2]["grad_norm"]),
                       g_max=max(float(np.abs(g).max())
                                 for g in jax.tree.leaves(np_(jg1)))))


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("world"), reference["inp"])


@pytest.fixture(params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def world(request, worlds):
    return request.param, worlds[request.param]


def _near(got, want, rel):
    return float((got - want).abs().max()) <= rel * max(
        float(want.abs().max()), 1e-30)


def test_prefill_matches_one_device(world, reference):
    _, ranks = world
    one = reference["one"]
    res = ranks[0]
    assert torch.equal(res["prefill_tok"], one["prefill_tok"])
    assert _near(res["prefill_logits"], one["prefill_logits"], 1e-5)
    assert _near(res["prefill_k"], one["prefill_k"], 1e-5)


def test_decode_matches_one_device(world, reference):
    _, ranks = world
    one = reference["one"]
    for res in ranks:
        assert torch.equal(res["decode_tok"], one["decode_tok"])
        assert torch.equal(res["decode_pos"], one["decode_pos"])
    for key in ("decode_k", "decode_v"):
        assert _near(ranks[0][key], one[key], 1e-5), key


def test_train_step_matches_one_device_and_repro(world, reference):
    _, ranks = world
    res, one = ranks[0], reference["one"]
    assert res["donated"]
    for want in (one["metrics"], reference["jax_metrics"]):
        for key in ("loss", "grad_norm"):
            assert abs(res["metrics"][key] - want[key]) \
                <= 1e-5 * abs(want[key]), key
    for want in (one["mu"], reference["jax_mu"]):
        for g, w in zip(res["mu"], want, strict=True):
            assert float((g - w).abs().max()) <= max(
                1e-4 * float(w.abs().max()), 1e-9)
    for g, w in zip(res["nu"], one["nu"], strict=True):
        assert float((g - w).abs().max()) <= max(
            1e-4 * float(w.abs().max()), 1e-12)


def test_update_from_identical_grads_matches_repro(world, reference):
    _, ranks = world
    res, want = ranks[0], reference["jax_upd"]
    for g, w in zip(res["upd_params"], want["params"], strict=True):
        assert float((g - w).abs().max()) <= 1e-6
    for key in ("mu", "nu"):
        scale = max(float(w.abs().max()) for w in want[key])
        for g, w in zip(res[f"upd_{key}"], want[key], strict=True):
            assert float((g - w).abs().max()) <= 1e-6 * scale, key
    assert abs(res["upd_grad_norm"] - want["grad_norm"]) \
        <= 1e-5 * want["grad_norm"]


def test_decode_gathers_the_cache_over_model(world, reference):
    """The bytes each rank receives to gather a decode step's caches over
    "model" (``ops.GATHERED_KV_BYTES``): every layer's k and v, this
    rank's rows, the (model - 1) / model of the sequence it lacks."""
    (data, model), ranks = world
    cfg = reference["cfg"]
    local = (B // data) * MAX_SEQ * cfg.n_kv_heads * cfg.d_head * 4
    want = DECODES * cfg.n_layers * 2 * local * (model - 1) // model
    assert reference["one"]["decode_gathered_bytes"] == 0
    for res in ranks:
        assert res["decode_gathered_bytes"] == want


def test_compressed_train_step_matches_one_device_and_repro(world,
                                                            reference):
    """``make_train_step(..., compressed_grads=True)``: loss and grad norm
    within 1e-5 relative of the one-device step's (the loss also of
    ``repro``'s step: the gradient is compressed after it); the error
    feedback, whose int8 scale is one a stacked leaf over the whole
    leaf, within 1e-3 of each leaf's largest entry (about half the int8
    step; the gradients' rounding moves it by ~1e-5 of that), but for
    entries whose code rounds the other way, a whole step apart: at most
    one in 10,000."""
    _, ranks = world
    res, one = ranks[0], reference["one"]
    for want, keys in ((one["c_metrics"], ("loss", "grad_norm")),
                       (reference["jax_metrics"], ("loss",))):
        for key in keys:
            assert abs(res["c_metrics"][key] - want[key]) \
                <= 1e-5 * abs(want[key]), key
    far = sum(int(((g - w).abs() > 1e-3 * float(w.abs().max())).sum())
              for g, w in zip(res["c_error"], one["c_error"], strict=True))
    total = sum(w.numel() for w in one["c_error"])
    assert far <= total // 10_000, (far, total)


def test_compressed_update_from_identical_state_matches_repro(world,
                                                              reference):
    """One compressed update from ``repro``'s state after a compressed
    update and its next gradient (identical on every mesh): parameters
    within 1e-6, moments within 1e-6 of their largest entry, the error
    feedback within 1e-6 of the largest gradient entry, against
    ``repro``'s update and the one-device update
    (``tests/test_torch_train.py``'s tolerances). Per-shard scales would
    move whole codes."""
    _, ranks = world
    want = reference["jax_c_upd"]
    for res in ranks[:1]:
        for other in (want, {k[len("c_upd_"):]: v for k, v in
                             reference["one"].items()
                             if k.startswith("c_upd_")}):
            for g, w in zip(res["c_upd_params"], other["params"],
                            strict=True):
                assert float((g - w).abs().max()) <= 1e-6
            for key in ("mu", "nu"):
                scale = max(float(w.abs().max()) for w in other[key])
                for g, w in zip(res[f"c_upd_{key}"], other[key],
                                strict=True):
                    assert float((g - w).abs().max()) <= 1e-6 * scale, key
            for g, w in zip(res["c_upd_error"], other["error"],
                            strict=True):
                assert float((g - w).abs().max()) <= 1e-6 * want["g_max"]
            assert abs(res["c_upd_grad_norm"] - other["grad_norm"]) \
                <= 1e-5 * other["grad_norm"]


def test_local_shards_are_the_specs_split(world, reference):
    """Every rank holds the spec's split of each leaf, and its bytes are
    ``sharded_size_bytes``: the dry run's per-device bytes."""
    shape, ranks = world
    cfg = reference["cfg"]
    mesh = Mesh(shape, ("data", "model"),
                [torch.device("cpu")] * (shape[0] * shape[1]))
    tr = make_train_step(cfg, mesh.abstract(), B, S,
                         opt_cfg=AdamWConfig(**OCFG))
    sizes = dict(zip(mesh.axis_names, shape))
    want = []
    for t, sh in zip(leaves(tr.args[:2]), leaves(tr.in_shardings[:2])):
        dims = list(t.shape)
        for d, e in enumerate(tuple(sh.spec)):
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    dims[d] //= sizes[a]
        want.append(tuple(dims))
    total = SH.sharded_size_bytes(tr.args[:2], tr.in_shardings[:2])
    for res in ranks:
        assert res["local_shapes"] == want
        assert res["local_bytes"] == res["want_bytes"] == total


def test_restore_onto_the_mesh_is_bitwise(world):
    _, ranks = world
    assert all(res["restored_bitwise"] for res in ranks)


def test_other_families_name_item_32(world):
    _, ranks = world
    for res in ranks:
        assert sorted(res["raises"]) == ["mamba2-370m", "qwen2-moe-a2.7b"]
        assert all("item 32" in m for m in res["raises"].values())


def test_world_mesh_needs_as_many_ranks(tmp_path):
    """In a one-rank world a (1, 1) mesh is the world's; another shape
    raises. Outside a world the mesh is the one device."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(device="cpu")
        assert mesh.distributed and mesh.device == torch.device("cpu")
        assert [str(p) for p in SH.NamedSharding(
            mesh, SH.P("data", "model")).placements] == \
            ["S(0)", "S(1)"]
        with pytest.raises(ValueError, match="world of 1"):
            make_debug_mesh(2, 1, device="cpu")
    finally:
        dist.destroy_process_group()
    assert not make_debug_mesh(device="cpu").distributed
