"""The ssm program's (mamba2-370m), the MoE decoder's (qwen2-moe-a2.7b)
and the hybrid's (jamba) step bundles in one 4-rank ``gloo`` world on the
CPU, meshed (2, 2), (4, 1) and (1, 4), at the smoke cuts and bars of
``tests/torch_mesh_world.py``, against the one-device steps and
``repro``'s.

* mamba2-370m (8 heads of 16, state 16, chunk 16): the SSD scan runs on
  each rank's heads under ``local_map`` (``kernels/ops.py::_local_ssd``).
  ``test_ssd_gradients_under_local_map`` holds its gradients to one
  device's autograd on every mesh: x, dt and the initial state by heads,
  A's partial over the rows, B's and C's partial over the heads (without
  those ``Partial()`` placements each rank's share would be taken for the
  whole gradient), within 1e-5 of each gradient's largest entry (float32,
  the same sums in another order).
* qwen2-moe-a2.7b (4 experts top-2 and a shared one, 4 heads on 2 kv
  heads): the experts split over "model" on every mesh (expert parallel,
  ``models/spmd.py::moe_dispatch``), and the routing runs on each rank's
  whole groups. Routing is integer arithmetic, so the prefill's kept
  routes must be identical, not close: to the one-device run's, and to
  ``repro``'s, whose top-k choices are recorded inside its jitted prefill
  and whose kept set is GShard's assignment of them (``_assign``: every
  token's choice c before any token's choice c + 1, a route kept while its
  expert has room).
* jamba (one period: attention, 4 heads on 2 kv heads, then 7 Mamba-2
  sublayers of 8 heads, an MoE of 4 experts on every other one): its
  cache folds ``repro``'s (n_periods, P-1) Mamba-2 state axes into one;
  the sharding rules resolve those leaves on ``repro``'s shape, where
  P - 1 = 7 splits over no axis, so the states are replicated on every
  rank (as ``repro`` places them) and every rank writes the whole state.
  The MoE sublayers' kept routes at prefill equal the one-device run's.
"""
import numpy as np
import pytest
import torch

import torch_mesh_world as W
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import make_decode_step
from repro_torch.models.moe import capacity
from repro_torch.models.transformer import _hybrid_layout

torch.set_num_threads(1)
SSM, MOE, HYBRID = "mamba2-370m", "qwen2-moe-a2.7b", "jamba-1.5-large-398b"
ARCHS = (SSM, MOE, HYBRID)
JOIN_S = 600
GRADS = ("x", "dt", "A", "B", "C", "initial_state")


def _ssd_inputs():
    """x (4, 32, 8, 16), dt, A, B/C (state 16), an initial state, and the
    cotangents of y and of the final state, from one seed."""
    g = torch.Generator().manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=g)
    b, l, h, p, n = 4, 32, 8, 16, 16
    args = [randn(b, l, h, p) * 0.5,
            torch.nn.functional.softplus(randn(b, l, h)),
            -torch.exp(randn(h) * 0.3), randn(b, l, n) * 0.5,
            randn(b, l, n) * 0.5, randn(b, h, p, n) * 0.5]
    return args, (randn(b, l, h, p), randn(b, h, p, n))


def _ssd_grads(cfg, mesh, inp):
    """The SSD scan's gradients of its six inputs: as DTensors on a
    distributed ``mesh`` (rows over "data", replicated over "model", as
    the model hands them over; the scan lays them out itself), or on one
    device."""
    args, (dy, dfin) = _ssd_inputs()
    if mesh.distributed:
        from torch.distributed.tensor import Replicate, Shard, \
            distribute_tensor
        dm = mesh.device_mesh
        rows = [Shard(0), Replicate()]
        args = [distribute_tensor(t, dm, [Replicate()] * 2 if i == 2
                                  else rows, src_data_rank=None)
                for i, t in enumerate(args)]
        dy, dfin = (distribute_tensor(t, dm, rows, src_data_rank=None)
                    for t in (dy, dfin))
    args = [t.requires_grad_(True) for t in args]
    y, fin = kernel_ops.ssd(*args[:5], chunk=16, initial_state=args[5])
    loss = (y * dy).sum() + (fin * dfin).sum()
    grads = torch.autograd.grad(loss, args)
    return {"ssd_grads": [W._full(t) for t in grads]}


EXTRAS = {SSM: _ssd_grads}


def _assign(idx, cap, e):
    """GShard's sequential-choice assignment of one group of (T, k)
    choices: the kept mask."""
    T, k = idx.shape
    counts, keep = np.zeros(e, int), np.zeros((T, k), bool)
    for c in range(k):
        for t in range(T):
            if counts[idx[t, c]] < cap:
                keep[t, c] = True
                counts[idx[t, c]] += 1
    return keep


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The world's results and the references, computed while it runs."""
    inits = {arch: W.repro_init(arch) for arch in ARCHS}

    def references():
        return {arch: W.reference(init, routes=arch == MOE,
                                  extra=EXTRAS.get(arch))
                for arch, init in inits.items()}
    return W.spawn(tmp_path_factory.mktemp("world"),
                   {arch: init["inp"] for arch, init in inits.items()},
                   JOIN_S, extras=EXTRAS, meanwhile=references)


def _ids(case):
    return f"{case[0]}-{case[1][0]}x{case[1][1]}"


@pytest.fixture(params=[(a, s) for a in ARCHS for s in W.MESHES], ids=_ids)
def case(request, run):
    """(reference, mesh shape, the ranks' results) of one config on one
    mesh."""
    arch, shape = request.param
    return run[1][arch], shape, run[0][arch, shape]


def _on(arch):
    return pytest.mark.parametrize(
        "case", [(arch, s) for s in W.MESHES], ids=_ids, indirect=True)


def test_prefill_matches_one_device(case):
    ref, _, ranks = case
    W.check_prefill(ranks[0], ref["one"])


def test_decode_matches_one_device_in_place(case):
    ref, _, ranks = case
    W.check_decode(ranks, ref["one"])


def test_train_step_matches_one_device_and_repro(case):
    ref, _, ranks = case
    W.check_train(ranks[0], ref["one"], ref)


def test_compressed_train_step_matches_one_device_and_repro(case):
    ref, _, ranks = case
    W.check_compressed(ranks[0], ref["one"], ref)


def test_microbatched_train_step_matches_one_device(case):
    ref, _, ranks = case
    W.check_microbatched(ranks[0], ref["one"])


def test_local_bytes_are_the_dry_runs(case):
    W.check_bytes(case[2])


def test_restore_onto_the_mesh_is_bitwise(case):
    assert all(res["restored_bitwise"] for res in case[2])


@_on(SSM)
def test_ssd_gradients_under_local_map(case):
    ref, _, ranks = case
    for res in ranks:
        for name, got, want in zip(GRADS, res["ssd_grads"],
                                   ref["one"]["ssd_grads"], strict=True):
            assert W.near(got, want, 1e-5), name


@_on(MOE)
def test_kept_routes_match_one_device_and_repro(case):
    """One (T, k) entry a layer; a prompt of 4 x 24 tokens is one group
    of 96 at capacity ``capacity(96)``, some routes dropped."""
    ref, _, ranks = case
    cfg, one = ref["cfg"], ref["one"]["routes"]
    tokens = W.B * W.PROMPT
    cap = capacity(tokens, cfg)
    jax_routes = ref["jax_routes"]
    assert len(one) == len(jax_routes) == cfg.n_layers
    dropped = 0
    for (idx, keep), jidx in zip(one, jax_routes, strict=True):
        assert np.array_equal(idx.numpy(), jidx.reshape(tokens, -1))
        want = _assign(idx.numpy(), cap, cfg.n_experts)
        assert np.array_equal(keep.numpy(), want)
        dropped += int((~want).sum())
    assert dropped > 0
    W.check_routes(ranks, ref["one"])


@_on(HYBRID)
def test_kept_routes_match_one_device(case):
    """One (T, k) entry an MoE sublayer (four in the period)."""
    ref, _, ranks = case
    one = ref["one"]["routes"]
    assert len(one) == len(_hybrid_layout(ref["cfg"])[2])
    W.check_routes(ranks, ref["one"])


@_on(HYBRID)
def test_folded_states_are_whole_on_every_rank(case):
    """The folded conv and ssm states split over no mesh dim: every rank
    holds (and writes) the whole state. The kv cache's rows are over
    "data", its slots over "model"."""
    ref, shape, _ = case
    mesh = Mesh(shape, ("data", "model"),
                [torch.device("cpu")] * (shape[0] * shape[1]))
    dec = make_decode_step(ref["cfg"], mesh.abstract(), W.B, W.MAX_SEQ)
    specs, shapes = dec.in_shardings[2], dec.args[2]
    for key in ("conv", "ssm"):
        assert specs[key].num_devices_sharded_over(shapes[key].shape) == 1
    assert tuple(specs["kv_k"].spec) == (None, "data", "model")
