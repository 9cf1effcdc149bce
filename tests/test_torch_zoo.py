"""The port's model zoo (``repro_torch/configs``: the ten configs and the
registry) against the JAX package's, and the smoke cuts of the dense and
MoE configs it builds, on the CPU.

 * every config equals ``repro``'s field by field, at full width and cut
   to ``.smoke()``, with the same parameter counts;
 * ``SHAPES``, ``sub_quadratic``, ``config_for_shape`` and ``cells()``
   (40 cells, 7 of them skipped) equal ``repro``'s;
 * the smoke cuts of qwen3-32b and chameleon-34b (``qk_norm``),
   internlm2-20b, mistral-large-123b (dense, GQA) and dbrx-132b (MoE, no
   shared expert) give ``repro``'s logits from ``repro``'s weights, after
   a prefill and over 3 decode steps (1e-4, the bar of
   ``tests/test_torch_model.py``);
 * jamba (hybrid) and whisper (encdec) are registered as data, and
   building either names its ROADMAP item;
 * the new modules (the configs, ``models/moe.py``, the three launchers)
   load neither ``jax`` nor ``repro``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import build as jax_build
import repro_torch
from repro_torch import configs
from repro_torch.models import build
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(jax_configs.ARCHS))
def test_config_copy_matches_repro(name):
    for cut in (lambda c: c, lambda c: c.smoke()):
        got, want = cut(configs.get(name)), cut(jax_configs.get(name))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.n_params() == want.n_params()
        assert got.n_params_active() == want.n_params_active()


def test_registry_order_and_lookup_match_repro():
    assert list(configs.ARCHS) == list(jax_configs.ARCHS)
    assert configs.get("qwen2_moe_a2.7b") is configs.ARCHS["qwen2-moe-a2.7b"]
    with pytest.raises(KeyError, match="known"):
        configs.get("llama-7b")


def test_shapes_and_cells_match_repro():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}
    for include_skips in (False, True):
        got = [(dataclasses.asdict(c), dataclasses.asdict(s), skip)
               for c, s, skip in configs.cells(include_skips)]
        want = [(dataclasses.asdict(c), dataclasses.asdict(s), skip)
                for c, s, skip in jax_configs.cells(include_skips)]
        assert got == want
    everything = configs.cells(include_skips=True)
    assert len(everything) == 40
    assert sum(skip is not None for _, _, skip in everything) == 7
    assert len(configs.cells()) == 33
    for name, cfg in configs.ARCHS.items():
        assert configs.sub_quadratic(cfg) == \
            jax_configs.sub_quadratic(jax_configs.ARCHS[name])
    jamba = configs.config_for_shape(configs.get("jamba-1.5-large-398b"),
                                     configs.SHAPES["long_500k"])
    assert jamba.window == 4096


@pytest.mark.parametrize("name,item", [("jamba-1.5-large-398b", "13b"),
                                       ("whisper-large-v3", "13a")])
def test_unported_families_name_their_item(name, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        build(configs.get(name))


@pytest.mark.parametrize("name", ["qwen3-32b", "chameleon-34b",
                                  "internlm2-20b", "mistral-large-123b",
                                  "dbrx-132b"])
def test_smoke_cut_logits_match_repro(name):
    jcfg = jax_configs.get(name).smoke()
    cfg = configs.get(name).smoke()
    jmodel = jax_build(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(1))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams))
    model = build(cfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 20))
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            max_seq=32)
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           max_seq=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jdecode = jax.jit(jmodel.decode)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1))
        jl, jc = jdecode(jparams, jnp.asarray(nxt[:, None], jnp.int32), jc)
        tl, tc = model.decode(params, torch.from_numpy(nxt[:, None].copy()),
                              tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_new_modules_import_neither_jax_nor_repro():
    mods = ["repro_torch.models.moe", "repro_torch.configs.registry",
            "repro_torch.launch.autoscale",
            "repro_torch.launch.fleet_autoscale",
            "repro_torch.launch.hetero_fleet"] + [
        f"repro_torch.configs.{c}" for c in (
            "chameleon_34b", "dbrx_132b", "internlm2_20b",
            "jamba_1_5_large_398b", "mistral_large_123b", "qwen2_moe_a2_7b",
            "qwen3_32b", "whisper_large_v3")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(n for n in sys.modules\n"
            "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr
