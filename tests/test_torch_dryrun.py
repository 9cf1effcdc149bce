"""The port's dry run (``repro_torch/launch/dryrun.py``) against
``repro``'s, on the CPU (meta tensors; no card, no compiler):

* ``model_flops`` and ``default_knobs`` equal ``repro``'s for every cell
  of ``cells(include_skips=True)``. ``repro``'s ``launch/dryrun.py`` sets
  ``XLA_FLAGS`` when imported, so the test takes its two functions from
  its source and imports nothing else of it;
* ``run_cell`` for gemma3-1b and mamba2-370m ``train_4k`` on the (16, 16)
  production mesh: ``arg_bytes_per_device`` equals the bytes of
  ``repro``'s rules over ``repro``'s abstract arguments (its
  ``params_shardings``, ``_opt_shardings`` and ``batch_shardings``, with
  JAX's ``NamedSharding`` replaced by a plain pair, which takes a fake
  mesh); the counts are global, the per-device ones that over 256; the
  kernels' rows are their own work (``forward_work``/``backward_work``
  once a layer) and priced at the kernels' peak;
* each family's smoke cut (decoder, MoE, ssm, hybrid, encoder-decoder),
  float32 with ``remat="none"``, 2 x 128 tokens: the port's counted
  matmul flops of a train step, the kernels counted by their plain
  versions (``totals(plain=True)``), lie within 2% of the dot flops of
  ``repro``'s compiled step on a 1 x 1 debug mesh (``hlo_cost.top_costs``).
  One product differs: in ``ssd_reference``'s state-to-output einsum
  (``"bcsn,bchpn,bhcs->bcshp"``) XLA scales by the decay as a dot with no
  contracting dimension, 2 flops an element of the (b, c, s, h, p)
  result, three a layer with the backward; ``torch.einsum`` multiplies
  elementwise, which the flop counter does not count (ssm: 0.31% fewer,
  hybrid 0.10%; ROADMAP Queue 3).
"""
import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro
import repro.launch.sharding as jax_sh
import repro.launch.steps as jax_steps
from repro.configs import cells as jax_cells
from repro.configs import get as jax_get
from repro.launch import make_debug_mesh as jax_debug_mesh
from repro.launch.hlo_cost import top_costs as jax_top_costs
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.model import input_specs as jax_input_specs
from repro.train import optimizer as jopt
from repro_torch.configs import SHAPES, cells, get
from repro_torch.kernels import flash_attention, ssd_scan
from repro_torch.launch import dryrun, make_debug_mesh, make_train_step
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import _layer_windows

torch.set_num_threads(1)


def _repro_functions(*names):
    """``names`` from ``repro/launch/dryrun.py``, without running its
    module-level code (which sets ``XLA_FLAGS``)."""
    src = Path(repro.__file__).parent / "launch" / "dryrun.py"
    tree = ast.parse(src.read_text())
    defs = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(d.name for d in defs) == sorted(names)
    ns = {"ModelConfig": JaxModelConfig}
    exec(compile(ast.Module(defs, type_ignores=[]), str(src), "exec"), ns)
    return [ns[n] for n in names]


def test_model_flops_and_knobs_equal_repro():
    jax_model_flops, jax_default_knobs = _repro_functions("model_flops",
                                                          "default_knobs")
    ours, theirs = cells(include_skips=True), jax_cells(include_skips=True)
    assert len(ours) == len(theirs) == 40
    for (cfg, shape, skip), (jcfg, jshape, jskip) in zip(ours, theirs):
        assert (cfg.name, shape.name, skip) == (jcfg.name, jshape.name, jskip)
        assert dryrun.model_flops(cfg, shape) == jax_model_flops(jcfg,
                                                                 jshape)
        assert dryrun.default_knobs(cfg) == jax_default_knobs(jcfg)
    # the roofline's peaks are one H100's (its data sheet, SXM)
    assert dryrun.PEAK_FLOPS["bfloat16"] == 989e12
    assert dryrun.PEAK_FLOPS["float32"] == 67e12 and dryrun.HBM_BW == 3.35e12


class _Sharding:
    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


class _FakeMesh:
    axis_names = ("data", "model")
    devices = np.empty((16, 16))


def _repro_arg_bytes(arch, shape):
    """Bytes a device of ``repro``'s (16, 16) mesh holds of a train cell's
    arguments under ``repro``'s rules (one batch: the knobs give 1
    microbatch below 10 B parameters)."""
    jcfg, mesh = jax_get(arch), _FakeMesh()
    p = jax_steps.abstract_params(jcfg)
    o = jax.eval_shape(jopt.adamw(jopt.AdamWConfig())[0], p)
    b = jax_input_specs(jcfg, "train", batch=shape.global_batch,
                        seq=shape.seq_len)
    psh = jax_sh.params_shardings(p, mesh)
    shardings = (psh, jax_steps._opt_shardings(o, psh, mesh),
                 jax_sh.batch_shardings(b, mesh))
    return jax_sh.sharded_size_bytes(
        jax.tree.leaves((p, o, b)), jax.tree.leaves(
            shardings, is_leaf=lambda x: isinstance(x, _Sharding)))


def _kernel_flops(arch, shape):
    """The flops of the kernels of a train step of ``shape``, forward and
    backward, by the work functions at each layer's shapes."""
    cfg, b, l = get(arch), shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        work = (b, l, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                min(cfg.ssm_chunk, l), 2)
        return cfg.n_layers * (ssd_scan.forward_work(*work, states=True)[1]
                               + ssd_scan.backward_work(*work)[1])
    q = torch.empty((b, cfg.n_heads, l, cfg.d_head), device="meta",
                    dtype=torch.bfloat16)
    k = torch.empty((b, cfg.n_kv_heads, l, cfg.d_head), device="meta",
                    dtype=torch.bfloat16)
    return sum(flash_attention.forward_work(q, k, window=w or 0, lse=True)[1]
               + flash_attention.backward_work(q, k, window=w or 0)[1]
               for w in _layer_windows(cfg))


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-370m"])
def test_run_cell_arg_bytes_equal_repro(arch, monkeypatch):
    monkeypatch.setattr(jax_sh, "NamedSharding", _Sharding)
    monkeypatch.setattr(jax_steps, "NamedSharding", _Sharding)
    shape = SHAPES["train_4k"]
    res = dryrun.run_cell(get(arch), shape, make_production_mesh(),
                          "pod16x16")
    assert res.arg_bytes_per_device == _repro_arg_bytes(arch, shape)
    mem = res.memory
    assert res.per_device_flops == mem["flops_global"] / 256
    assert res.per_device_bytes == mem["bytes_global"] / 256
    assert mem["microbatches"] == 1 and mem["remat_applied"] == "none"
    assert mem["remat_asked"] == "dots"
    assert res.useful_flops_frac == round(
        res.model_flops / mem["flops_global"], 4)
    assert mem["kernel_flops_global"] == _kernel_flops(arch, shape)
    # the plain versions compute the masked blocks the kernels skip
    assert mem["flops_plain_global"] > mem["flops_global"]
    dtype = get(arch).dtype
    assert res.compute_s == (
        (mem["flops_global"] - mem["kernel_flops_global"])
        / dryrun.PEAK_FLOPS[dtype]
        + mem["kernel_flops_global"] / dryrun.KERNEL_PEAK_FLOPS[dtype]) / 256
    assert res.memory_s == res.per_device_bytes / dryrun.HBM_BW
    assert res.collectives == {} and res.collective_s == 0.0
    assert res.bottleneck in ("compute", "memory")


FAMILIES = {"decoder": "gemma3-1b", "moe": "qwen2-moe-a2.7b",
            "ssm": "mamba2-370m", "hybrid": "jamba-1.5-large-398b",
            "encdec": "whisper-large-v3"}
# a product repro's XLA counts as a dot and the port multiplies elementwise
# (the module docstring); the bar stays 2% for every family
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_smoke_train_step_matmul_flops_match_repro(family):
    arch = FAMILIES[family]
    kw = dict(dtype="float32", remat="none")
    jcfg = dataclasses.replace(jax_get(arch).smoke(), **kw)
    cfg = dataclasses.replace(get(arch).smoke(), **kw)
    jb = jax_steps.make_train_step(jcfg, jax_debug_mesh(1, 1), batch=2,
                                   seq=128)
    hlo = jax.jit(jb.fn).lower(*jb.args).compile(
        compiler_options=FAST_COMPILE).as_text()
    dots = sum(r["flops"] for r in jax_top_costs(hlo, k=10 ** 6)
               if r["op"] == "dot")
    bundle = make_train_step(cfg, make_debug_mesh(device="cpu").abstract(),
                             2, 128)
    _, cost = op_cost.count(bundle.fn, *bundle.args)
    matmul = sum(r.flops for r in cost.rows.values() if not r.kernel
                 and r.op in ("aten.mm", "aten.bmm", "aten.addmm"))
    assert matmul == cost.totals(plain=True)["flops"]
    assert matmul == pytest.approx(dots, rel=0.02), (matmul, dots)
    if family not in ("ssm", "hybrid"):
        assert matmul == dots
