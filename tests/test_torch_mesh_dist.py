"""The dense decoder's step bundles on a real ``torch.distributed`` mesh:
a 4-rank ``gloo`` world on the CPU, meshed (2, 2), (4, 1) and (1, 4) in
turn, gemma3-1b's smoke cut in float32 (4 query heads on one kv
head, d_head 16: "model" would cut the kv head, as at full width).

Each mesh places ``repro``'s initial weights by the bundles' shardings
(``launch/sharding.py::place``) and runs the prefill step (4 rows of 24
tokens into a 48-slot cache), three decode steps and one train step
(4 x 32 tokens), a compressed one and one of two microbatches as
DTensors; each rank writes its results whole. Against
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
  bit for bit.

The other families run on the same meshes in
``tests/test_torch_mesh_families.py`` and
``tests/test_torch_mesh_encdec.py``.

One 4-rank world runs the three meshes (``tests/torch_mesh_world.py``,
which also sets the bars above; the dense decoder's own checks are its
``extras``), joined within 360 s of its spawn (other tests share the
cores) or killed, failing the test.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_world as W
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import Mesh, make_debug_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.train.optimizer import AdamWConfig, adamw, compressed_adamw
from repro_torch.train.tree import leaves, map_tree

torch.set_num_threads(1)
ARCH = "gemma3-1b"
MESHES, B, S, OCFG = W.MESHES, W.B, W.S, W.OCFG
MAX_SEQ, DECODES = W.MAX_SEQ, W.DECODES
JOIN_S = 360


def _updates(cfg, mesh, inp):
    """One AdamW update from ``repro``'s gradients (``inp["grads"]``), and
    one compressed update from ``repro``'s state after a compressed update
    with its next gradient (``inp["compressed"]``), both on ``mesh``."""
    tr = make_train_step(cfg, mesh, B, S, opt_cfg=AdamWConfig(**OCFG))
    p_sh, o_sh = tr.in_shardings[:2]

    def placed(tree, sh):
        return SH.place(tree, sh) if mesh.distributed else tree
    init, update = adamw(AdamWConfig(**OCFG))
    p = placed(map_tree(torch.clone, inp["params"]), p_sh)
    p3, o3, m3 = update(placed(inp["grads"], p_sh),
                        placed(init(inp["params"]), o_sh), p)
    out = {"upd_params": [W._full(t) for t in leaves(p3)],
           "upd_mu": [W._full(t) for t in leaves(o3.mu)],
           "upd_nu": [W._full(t) for t in leaves(o3.nu)],
           "upd_grad_norm": float(W._full(m3["grad_norm"]))}
    comp = inp["compressed"]
    _, update = compressed_adamw(AdamWConfig(**OCFG))
    o_sh = make_train_step(cfg, mesh, B, S, opt_cfg=AdamWConfig(**OCFG),
                           compressed_grads=True).in_shardings[1]
    p3, o3, m3 = update(placed(comp["grads"], p_sh),
                        placed(map_tree(torch.clone, comp["state"]), o_sh),
                        placed(map_tree(torch.clone, comp["params"]), p_sh))
    out.update(c_upd_params=[W._full(t) for t in leaves(p3)],
               c_upd_mu=[W._full(t) for t in leaves(o3.inner.mu)],
               c_upd_nu=[W._full(t) for t in leaves(o3.inner.nu)],
               c_upd_error=[W._full(t) for t in leaves(o3.error)],
               c_upd_grad_norm=float(W._full(m3["grad_norm"])))
    return out


def _repro_updates(init):
    """``repro``'s gradient at its initial weights and its update from
    it; its state after one compressed update, its next gradient and the
    compressed update from them. Adds the port's copies of the inputs to
    ``init["inp"]`` (``grads``, ``compressed``)."""
    import jax

    from repro.train import optimizer as jopt
    from repro_torch.models.convert import opt_state_from_numpy, \
        params_from_numpy

    cfg, jp, jmodel = init["cfg"], init["jp"], init["jmodel"]
    grad = jax.jit(jax.grad(lambda p: jmodel.loss(p, init["jbatch"])[0]))
    jgrads = grad(jp)
    jinit, jupdate = jopt.adamw(jopt.AdamWConfig(**OCFG))
    jup = jax.jit(jupdate)(jgrads, jinit(jp), jp)
    jcinit, jcupdate = jopt.compressed_adamw(jopt.AdamWConfig(**OCFG))
    jcupdate = jax.jit(jcupdate)
    jp1, js1, _ = jcupdate(jgrads, jcinit(jp), jp)
    jg1 = grad(jp1)
    jcup = jcupdate(jg1, js1, jp1)

    def np_(t):
        return jax.tree.map(np.asarray, t)

    def port(t):
        return leaves(params_from_numpy(cfg, np_(t)))
    init["inp"]["grads"] = params_from_numpy(cfg, np_(jgrads))
    init["inp"]["compressed"] = dict(
        params=params_from_numpy(cfg, np_(jp1)),
        state=opt_state_from_numpy(cfg, np_(js1)),
        grads=params_from_numpy(cfg, np_(jg1)))
    return dict(jax_upd=dict(params=port(jup[0]), mu=port(jup[1].mu),
                             nu=port(jup[1].nu),
                             grad_norm=float(jup[2]["grad_norm"])),
                jax_c_upd=dict(params=port(jcup[0]),
                               mu=port(jcup[1].inner.mu),
                               nu=port(jcup[1].inner.nu),
                               error=port(jcup[1].error),
                               grad_norm=float(jcup[2]["grad_norm"]),
                               g_max=max(float(np.abs(g).max())
                                         for g in jax.tree.leaves(
                                             np_(jg1)))))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The world's results, and the references (``repro``'s initial
    weights, gradient, one-device jitted train step and updates; the
    port's one-device steps on the same inputs), computed while it
    runs."""
    init = W.repro_init(ARCH)
    updates = _repro_updates(init)

    def reference():
        return {**W.reference(init, extra=_updates), **updates}
    return W.spawn(tmp_path_factory.mktemp("world"), {ARCH: init["inp"]},
                   JOIN_S, extras={ARCH: _updates}, meanwhile=reference)


@pytest.fixture(scope="module")
def reference(run):
    return run[1]


@pytest.fixture(params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def world(request, run):
    return request.param, run[0][ARCH, request.param]


def test_prefill_matches_one_device(world, reference):
    W.check_prefill(world[1][0], reference["one"])


def test_decode_matches_one_device(world, reference):
    """Tokens on every rank, the caches, written in place."""
    W.check_decode(world[1], reference["one"])


def test_train_step_matches_one_device_and_repro(world, reference):
    W.check_train(world[1][0], reference["one"], reference)


def test_microbatched_train_step_matches_one_device(world, reference):
    W.check_microbatched(world[1][0], reference["one"])


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
    W.check_compressed(world[1][0], reference["one"], reference)


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
        assert res["state_bytes"] == (total, total)


def test_restore_onto_the_mesh_is_bitwise(world):
    _, ranks = world
    assert all(res["restored_bitwise"] for res in ranks)


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
