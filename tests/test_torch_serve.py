"""The port's continuous-batching engine (src/repro_torch/serve) against
the JAX package's, on the gemma3-1b and mamba2-370m ``.smoke()`` configs
in float32.

Invariants under test:
 * seeded token streams equal those of ``repro``'s ``ServingEngine`` with
   the Pallas decode kernel in interpret mode, prompts longer than the
   16-token window, more requests than slots;
 * for mamba2 (a recurrent cache of conv and SSM states), seeded token
   streams equal ``repro``'s with the SSD scan's Pallas kernel in interpret
   mode: exact-length prefill, 5- to 40-token prompts, more requests than
   slots;
 * an idle lane free-running past ``max_seq`` changes no live stream;
 * the engine runs on the card unless told otherwise, and raises when
   there is none;
 * the package imports neither ``jax`` nor ``repro``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.models import build as jax_build
from repro.serve import engine as jax_engine
import repro_torch
from repro_torch.configs import get
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model, build
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import (EngineConfig, Request, ServingEngine,
                                      bucket_length)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_get("gemma3-1b").smoke(), dtype="float32",
                               attn_impl="pallas_interpret")
    jmodel = jax_build(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get("gemma3-1b").smoke(), dtype="float32")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, build(cfg), params, cfg


def _requests(cls, vocab, lengths, max_new, seed, n=None):
    rng = np.random.default_rng(seed)
    n = len(lengths) if n is None else n
    return [cls(rid, rng.integers(0, vocab, lengths[rid % len(lengths)])
                .astype(np.int32), max_new_tokens=max_new[rid % len(max_new)])
            for rid in range(n)]


def _run(engine, reqs, max_steps=200):
    for r in reqs:
        engine.submit(r)
    for _ in range(max_steps):
        engine.step()
        if len(engine.completed) == len(reqs):
            break
    assert len(engine.completed) == len(reqs)
    return {r.rid: list(r.generated) for r in engine.completed}


def test_streams_match_reference_engine(models):
    jmodel, jparams, model, params, cfg = models
    lengths, max_new = [20, 31, 9, 26, 17], [5, 3, 6]
    ecfg = dict(slots=3, max_seq=64, context=32, chips=4.0)
    want = _run(jax_engine.ServingEngine(jmodel, jparams,
                                         jax_engine.EngineConfig(**ecfg)),
                _requests(jax_engine.Request, cfg.vocab, lengths, max_new, 0,
                          n=7))
    got = _run(ServingEngine(model, params, EngineConfig(**ecfg),
                             device="cpu"),
               _requests(Request, cfg.vocab, lengths, max_new, 0, n=7))
    assert got == want


@pytest.fixture(scope="module")
def mamba_models():
    jcfg = dataclasses.replace(jax_get("mamba2-370m").smoke(),
                               dtype="float32", ssm_impl="pallas_interpret")
    jmodel = jax_build(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get("mamba2-370m").smoke(), dtype="float32")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, build(cfg), params, cfg


def test_mamba2_streams_match_reference_engine(mamba_models, monkeypatch):
    """Exact-length prefill (no buckets) of 5- to 40-token prompts, 7
    requests through 3 slots; every cache leaf of a slot is replaced at
    admission, and idle lanes keep decoding."""
    jmodel, jparams, model, params, cfg = mamba_models
    lengths, max_new = [5, 40, 17, 26, 9], [5, 3, 6]
    ecfg = dict(slots=3, max_seq=64, context=48, chips=4.0)
    jeng = jax_engine.ServingEngine(jmodel, jparams,
                                    jax_engine.EngineConfig(**ecfg))
    want = _run(jeng, _requests(jax_engine.Request, cfg.vocab, lengths,
                                max_new, 3, n=7))
    widths = []
    prefill = Model.prefill

    def spy(self, params, batch, *args, **kw):
        widths.append(batch["tokens"].shape[1])
        return prefill(self, params, batch, *args, **kw)
    monkeypatch.setattr(Model, "prefill", spy)
    got = _run(ServingEngine(model, params, EngineConfig(**ecfg),
                             device="cpu"),
               _requests(Request, cfg.vocab, lengths, max_new, 3, n=7))
    assert got == want
    assert sorted(widths) == sorted(lengths[i % 5] for i in range(7))


def test_idle_lane_past_max_seq_changes_no_live_stream(models):
    """Request 0 finishes after 2 tokens; its lane free-runs ~30 steps, past
    max_seq = 32 (writes clamp to the last slot), while request 1 decodes to
    the end of its cache. Request 1's stream equals its stream alone."""
    _, _, model, params, cfg = models
    ecfg = dict(slots=2, max_seq=32, context=32, chips=4.0)
    both = ServingEngine(model, params, EngineConfig(**ecfg), device="cpu")
    reqs = _requests(Request, cfg.vocab, [8, 4], [2, 28], seed=5)
    streams = _run(both, reqs)
    assert int(both._cache["pos"][0]) > ecfg["max_seq"]      # past the cache
    alone = ServingEngine(model, params, EngineConfig(**ecfg), device="cpu")
    solo = _requests(Request, cfg.vocab, [8, 4], [2, 28], seed=5)[1:]
    assert _run(alone, solo)[1] == streams[1]


def test_engine_defaults_to_cuda_and_raises_without_it(models, monkeypatch):
    _, _, model, params, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(model, params, EngineConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--requests", "1"])


def test_engine_refuses_params_on_another_device(models):
    _, _, model, params, _ = models
    with pytest.raises(ValueError, match="params on"):
        ServingEngine(model, {**params, "embed": params["embed"].to("meta")},
                      EngineConfig(), device="cpu")


def test_admission_budget_and_buckets_match_reference(models):
    _, _, model, params, cfg = models
    for n in (1, 8, 9, 33, 64, 100):
        assert bucket_length(n, 64) == jax_engine.bucket_length(n, 64)
    engine = ServingEngine(model, params, EngineConfig(
        slots=4, max_seq=64, context=32, chips=0.5), device="cpu")
    budget = int(engine.cfg.chips * engine.cfg.tokens_per_chip_step)
    reqs = _requests(Request, cfg.vocab, [10, 20, 30], [3], seed=1, n=9)
    for r in reqs:
        engine.submit(r)
    prev = 0
    for _ in range(60):
        engine.step()
        assert engine.prompt_tokens_in - prev <= budget
        prev = engine.prompt_tokens_in
        if len(engine.completed) == len(reqs):
            break
    assert len(engine.completed) == len(reqs)
    assert all(len(r.generated) == 3 for r in engine.completed)


def test_launcher_serves_on_cpu():
    engine = launch_serve.main(["--device", "cpu", "--requests", "3",
                                "--prompt-len", "20", "--max-new", "4"])
    assert len(engine.completed) == 3
    assert all(len(r.generated) == 4 for r in engine.completed)


def test_launcher_serves_mamba2_on_cpu():
    engine = launch_serve.main(["--arch", "mamba2-370m", "--device", "cpu",
                                "--requests", "5", "--prompt-len", "21",
                                "--max-new", "4", "--slots", "2"])
    assert engine.model.cfg.name == "mamba2-370m-smoke"
    assert len(engine.completed) == 5
    assert all(len(r.generated) == 4 for r in engine.completed)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(' '.join(n for n in sys.modules if n.startswith('repro_torch')))"
        "\n")
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert len(loaded) >= 53                      # every module was imported
    assert {"repro_torch.obs.slo_accounting", "repro_torch.serve.service",
            "repro_torch.serve.loop", "repro_torch.env.scenarios",
            "repro_torch.core.fleet", "repro_torch.launch.failover",
            "repro_torch.core.forecast", "repro_torch.obs.registry",
            "repro_torch.obs.prometheus", "repro_torch.core.agents.vpa",
            "repro_torch.core.agents.dqn",
            "repro_torch.launch.compare_solvers"} <= loaded
