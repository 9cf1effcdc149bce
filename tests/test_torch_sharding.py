"""The port's sharding rules, mesh and step bundles
(``repro_torch/launch/{sharding,mesh,steps}.py``) against ``repro``'s, on
the CPU.

* the counterparts of ``tests/test_sharding.py``'s four tests: the
  divisibility fallbacks, attention and norm specs, the long-context
  cache fallback, and a tiny train step through the ``StepBundle`` on the
  CPU mesh that runs and equals the one-batch step;
* spec by spec against ``repro``'s rules, on ``FakeMesh`` objects (4, 4),
  (16, 16) and (2, 16, 16), for all ten configs at full size: every leaf
  of the parameters, the AdamW and compressed optimizer states, the train
  batches (one batch and microbatched) and the decode caches. ``repro``'s
  rule functions run as they are; only the ``NamedSharding`` they wrap a
  spec in is replaced by a plain (mesh, spec) pair, since JAX's takes no
  fake mesh. The port's leaves are mapped to ``repro``'s layout first
  (``launch/sharding.py``): per-layer lists against stacked axes, the
  (out, in) linears and vocab head against (in, out), the hybrid cache's
  folded (n_periods * (P-1)) state axis;
* ``sharded_size_bytes`` equals ``repro``'s ``_spec_shards`` sum byte for
  byte, for the caches over every leaf but the cursor ``pos``: the port
  keeps one int64 a row, ``repro`` one int32 scalar (ROADMAP Queue 3);
  both replicate it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.launch.sharding as jax_sh
import repro.launch.steps as jax_steps
from repro.configs import ARCHS as JAX_ARCHS
from repro.models.model import input_specs as jax_input_specs
from repro.train import optimizer as jopt
from repro_torch.configs import ARCHS, get
from repro_torch.launch import (StepBundle, abstract_params, batch_axes,
                                make_debug_mesh, make_production_mesh,
                                make_train_step)
from repro_torch.launch.sharding import (P, _pick, batch_shardings,
                                         cache_shardings, param_spec_resolved,
                                         params_shardings, sharded_size_bytes)
from repro_torch.launch.steps import _opt_shardings, input_specs
from repro_torch.models import build
from repro_torch.train.optimizer import AdamWConfig, adamw, compressed_adamw
from repro_torch.train.tree import leaves, map_tree, stack_keys

torch.set_num_threads(1)
CPU = torch.device("cpu")


def fake_mesh(shape):
    class FakeMesh:
        axis_names = ("pod", "data", "model")[-len(shape):]
        devices = np.empty(shape)
    return FakeMesh()


MESHES = {"4x4": (4, 4), "16x16": (16, 16), "2x16x16": (2, 16, 16)}


# -- repro's test_sharding.py cases ----------------------------------------------

def test_param_spec_divisibility_fallback():
    mesh = fake_mesh((4, 4))
    # vocab 50280 divides a 4-way axis, not a 16-way one
    assert param_spec_resolved(("embed",), (50280, 1024), mesh,
                               True) == P("model", "data")
    assert param_spec_resolved(("embed",), (50280, 1024), fake_mesh(
        (16, 16)), True) == P(None, "data")
    assert param_spec_resolved(("embed",), (65536, 8192), mesh,
                               True) == P("model", "data")
    # moe experts: 16 and 60 divide 4 -> EP
    up16 = param_spec_resolved(("layers", "ffn", "up"), (8, 16, 64, 128),
                               mesh, True)
    up60 = param_spec_resolved(("layers", "ffn", "up"), (8, 60, 64, 128),
                               mesh, True)
    assert tuple(up16)[1] == "model" and tuple(up60)[1] == "model"
    # on the production 16-way model axis 60 experts do NOT divide -> TP
    up60b = param_spec_resolved(("layers", "ffn", "up"), (8, 60, 64, 128),
                                fake_mesh((16, 16)), True)
    assert tuple(up60b)[1] is None and tuple(up60b)[3] == "model"
    # the port's per-layer expert leaf (60, 64, 128) gets the same spec
    tree = {"layers": [{"ffn": {"up": torch.empty((60, 64, 128),
                                                  device="meta")}}] * 8}
    sh = leaves(params_shardings(tree, fake_mesh((16, 16))))[0]
    assert tuple(sh.spec) == tuple(up60b)[1:]


def test_attention_and_norm_specs():
    mesh = fake_mesh((4, 4))
    wq = param_spec_resolved(("layers", "attn", "wq", "w"),
                             (26, 1152, 1024), mesh, True)
    assert tuple(wq) == (None, "data", "model")
    wo = param_spec_resolved(("layers", "attn", "wo", "w"),
                             (26, 1024, 1152), mesh, True)
    assert tuple(wo) == (None, "model", "data")
    ln = param_spec_resolved(("layers", "ln1", "scale"), (26, 1152), mesh,
                             True)
    assert tuple(ln) == ()
    # the port's (out, in) per-layer leaves: the entries swap, no prefix
    meta = dict(device="meta")
    layer = {"attn": {"wq": {"w": torch.empty((1024, 1152), **meta)},
                      "wo": {"w": torch.empty((1152, 1024), **meta)}},
             "ln1": {"scale": torch.empty((1152,), **meta)}}
    sh = params_shardings({"layers": [layer] * 26}, mesh)["layers"][3]
    assert tuple(sh["attn"]["wq"]["w"].spec) == ("model", "data")
    assert tuple(sh["attn"]["wo"]["w"].spec) == ("data", "model")
    assert tuple(sh["ln1"]["scale"].spec) == (None,)


def test_cache_shardings_long_context_fallback():
    mesh = fake_mesh((16, 16))
    # batch=1 can't shard over data -> falls to context sharding over model
    spec = _pick((26, 1, 524288, 1, 256), mesh, P(None, "data", "model"),
                 P(None, None, "model"))
    assert tuple(spec) == (None, None, "model")
    cache = input_specs(get("gemma3-1b"), "decode", batch=1, seq=524288)
    sh = cache_shardings(cache["cache"], mesh)
    assert tuple(sh["k"].spec) == (None, None, "model")
    assert tuple(sh["pos"].spec) == ()


def test_tiny_spmd_train_step_executes():
    """The bundle the dry run prices also runs: qwen3-32b's smoke cut, 2
    microbatches, on the CPU mesh, from seeded weights. Its abstract
    arguments equal the real state leaf for leaf, it writes the state in
    place (``donate_argnums``), and its loss and grad norm equal the
    one-batch bundle step's within 1e-5 relative
    (``tests/test_torch_train.py`` holds both against ``repro``'s)."""
    cfg = dataclasses.replace(get("qwen3-32b").smoke(), dtype="float32",
                              remat="none")
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    mesh = make_debug_mesh(device="cpu")
    init = build(cfg).init(torch.Generator().manual_seed(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 16))
    batch = {"tokens": toks.astype(np.int32),
             "labels": np.roll(toks, -1, axis=-1).astype(np.int32)}
    out = {}
    for m in (1, 2):
        bundle = make_train_step(cfg, mesh, batch=4, seq=16,
                                 microbatches=m, opt_cfg=ocfg)
        assert isinstance(bundle, StepBundle)
        assert bundle.donate_argnums == (0, 1)
        params = map_tree(torch.clone, init)
        opt = adamw(ocfg)[0](params)
        assert [(tuple(t.shape), t.dtype)
                for t in leaves(bundle.args[:2])] \
            == [(tuple(t.shape), t.dtype) for t in leaves((params, opt))]
        assert all(t.device.type == "meta" for t in leaves(bundle.args))
        assert tuple(bundle.args[2]["tokens"].shape) == (
            (4, 16) if m == 1 else (2, 2, 16))
        p2, o2, metrics = bundle.fn(params, opt, {
            k: v.reshape(tuple(bundle.args[2][k].shape))
            for k, v in batch.items()})
        assert p2 is params and int(o2.step) == 1
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
        out[m] = metrics
    for key in ("loss", "grad_norm"):
        assert abs(float(out[2][key]) - float(out[1][key])) \
            <= 1e-5 * abs(float(out[1][key])), key


def test_meshes():
    prod = make_production_mesh()
    assert prod.devices.shape == (16, 16) and prod.size == 256
    assert prod.axis_names == ("data", "model") and prod.device.type == "meta"
    multi = make_production_mesh(multi_pod=True)
    assert multi.devices.shape == (2, 16, 16)
    assert batch_axes(multi) == ("pod", "data") and batch_axes(prod) == (
        "data",)
    cpu = make_debug_mesh(device="cpu")
    assert cpu.devices.shape == (1, 1) and cpu.device == CPU
    with pytest.raises(AssertionError):
        make_debug_mesh(2, 1, device="cpu")


# -- spec by spec against repro, all ten configs, three fake meshes ------------

class _Sharding:
    """A (mesh, spec) pair in place of JAX's ``NamedSharding``, which takes
    no fake mesh; it has no ``num_devices_sharded_over``, so ``repro``'s
    ``sharded_size_bytes`` sums ``_spec_shards``."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


@pytest.fixture
def plain_named_sharding(monkeypatch):
    monkeypatch.setattr(jax_sh, "NamedSharding", _Sharding)
    monkeypatch.setattr(jax_steps, "NamedSharding", _Sharding)


_TREES = {}


def _trees(name):
    """Both packages' abstract state, batches and decode cache of a
    config at full size (train_4k's batch, decode_32k's cache)."""
    if name not in _TREES:
        jcfg, cfg = JAX_ARCHS[name], ARCHS[name]
        jp = jax_steps.abstract_params(jcfg)
        p = abstract_params(cfg)
        _TREES[name] = dict(
            jp=jp, p=p,
            jo=jax.eval_shape(jopt.adamw(jopt.AdamWConfig())[0], jp),
            o=adamw(AdamWConfig())[0](p),
            jco=jax.eval_shape(jopt.compressed_adamw(jopt.AdamWConfig())[0],
                               jp),
            co=compressed_adamw(AdamWConfig())[0](p),
            jb=jax_input_specs(jcfg, "train", batch=256, seq=4096),
            b=input_specs(cfg, "train", batch=256, seq=4096),
            jc=jax_input_specs(jcfg, "decode", batch=128, seq=32768)["cache"],
            c=input_specs(cfg, "decode", batch=128, seq=32768)["cache"])
    return _TREES[name]


def _by_path(tree, shardings):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    sh = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(
        x, _Sharding))
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            (tuple(leaf.shape), tuple(s.spec)) for (path, leaf), s in
            zip(flat, sh)}


def _padded(spec, rank):
    return tuple(spec) + (None,) * (rank - len(tuple(spec)))


def _port_layout(path, port_shape, repro_shape, spec):
    """``repro``'s spec of a stacked leaf in the port's layout: drop the
    stacked prefix, swap the entries of an (out, in) leaf."""
    entries = _padded(spec, len(repro_shape))
    entries = entries[len(repro_shape) - len(port_shape):]
    names = [p for p in path if isinstance(p, str)]
    if len(port_shape) == 2 and (names[-1] == "w" or names == ["head"]):
        assert port_shape == repro_shape[-2:][::-1]
        entries = entries[::-1]
    return entries


def _jax_bytes(tree, shardings):
    return jax_sh.sharded_size_bytes(
        jax.tree.leaves(tree), jax.tree.leaves(
            shardings, is_leaf=lambda x: isinstance(x, _Sharding)))


def _check_params_like(tree, shardings, jtree, jshardings):
    want = _by_path(jtree, jshardings)
    n = 0
    for path, leaf, sh in zip(stack_keys(tree), leaves(tree),
                              leaves(shardings)):
        rshape, rspec = want[path]
        got = _padded(sh.spec, leaf.dim())
        assert got == _port_layout(path, tuple(leaf.shape), rshape, rspec), \
            (path, got, rspec)
        n += 1
    assert n == len(leaves(tree))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_and_bytes_equal_repro(arch, mesh_name, plain_named_sharding):
    mesh = fake_mesh(MESHES[mesh_name])
    t = _trees(arch)

    # parameters
    psh = params_shardings(t["p"], mesh)
    jpsh = jax_sh.params_shardings(t["jp"], mesh)
    _check_params_like(t["p"], psh, t["jp"], jpsh)
    assert sharded_size_bytes(t["p"], psh) == _jax_bytes(t["jp"], jpsh)

    # optimizer states: moments like their parameters, the step replicated
    for o, jo in ((t["o"], t["jo"]), (t["co"], t["jco"])):
        osh = _opt_shardings(o, t["p"], psh, mesh)
        josh = jax_steps._opt_shardings(jo, jpsh, mesh)
        inner, jinner = (o, jo) if hasattr(o, "mu") else (o.inner, jo.inner)
        isub = osh if hasattr(o, "mu") else osh.inner
        jisub = josh if hasattr(jo, "mu") else josh.inner
        assert tuple(isub.step.spec) == tuple(jisub.step.spec) == ()
        for field in ("mu", "nu"):
            _check_params_like(getattr(inner, field), getattr(isub, field),
                               getattr(jinner, field), getattr(jisub, field))
        if not hasattr(o, "mu"):
            _check_params_like(o.error, osh.error, jo.error, josh.error)
        assert sharded_size_bytes(o, osh) == _jax_bytes(jo, josh)

    # train batches: one batch (dim 0) and 8 microbatches (dim 1)
    for m in (1, 8):
        b = {k: torch.empty((m, 256 // m) + tuple(v.shape[1:]),
                            dtype=v.dtype, device="meta")
             for k, v in t["b"].items()} if m > 1 else t["b"]
        jb = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
            (m, 256 // m) + s.shape[1:], s.dtype), t["jb"]) if m > 1 \
            else t["jb"]
        bsh = batch_shardings(b, mesh, dim=int(m > 1))
        jbsh = jax_sh.batch_shardings(jb, mesh, dim=int(m > 1))
        assert {k: tuple(v.spec) for k, v in bsh.items()} \
            == {k: tuple(v.spec) for k, v in jbsh.items()}
        assert sharded_size_bytes(b, bsh) == _jax_bytes(jb, jbsh)

    # decode caches
    csh = cache_shardings(t["c"], mesh)
    jcsh = jax_sh.cache_shardings(t["jc"], mesh)
    assert sorted(t["c"]) == sorted(t["jc"])
    for key, leaf in t["c"].items():
        jshape = tuple(t["jc"][key].shape)
        want = _padded(jcsh[key].spec, len(jshape))
        if leaf.dim() == len(jshape) - 1 and key in ("conv", "ssm"):
            # the hybrid's folded (n_periods * (P-1)) state axis
            assert tuple(leaf.shape) == (jshape[0] * jshape[1],) + jshape[2:]
            first = tuple(a for e in want[:2] if e is not None
                          for a in (e if isinstance(e, tuple) else (e,)))
            want = ((None if not first else first[0] if len(first) == 1
                     else first),) + want[2:]
        elif key == "pos":                 # one a row against one scalar
            assert tuple(leaf.shape) == (128,) and jshape == ()
            want = (None,)
        assert _padded(csh[key].spec, leaf.dim()) == want, (key, want)
    rest = [k for k in sorted(t["c"]) if k != "pos"]
    assert sharded_size_bytes([t["c"][k] for k in rest],
                              [csh[k] for k in rest]) \
        == _jax_bytes([t["jc"][k] for k in rest], [jcsh[k] for k in rest])
    assert sharded_size_bytes(t["c"]["pos"], csh["pos"]) == 128 * 8
