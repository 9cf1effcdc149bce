"""The port's served-LM slice (src/repro_torch/serve: ``DictCacheEngine``,
``ServedLMService``, ``run_serving_loop``; ``env/scenarios.py``;
``env/profiles.py::lm_profile``) against ``repro``'s, on the gemma3-1b
``.smoke()`` config in float32 on the CPU. ``repro``'s weights go through
``models/convert.py::params_from_numpy``, every rung's included, so both
packages serve with the same numbers.

Invariants under test:
 * the port's dict engine emits ``repro``'s dict engine's token streams,
   and the port's stacked engine emits the same streams as its dict engine;
 * admission budget and truncation follow ``repro``'s;
 * the served profile's ``tp_max`` is never evaluated; chips, context and
   rung land on the engine, and a rung switch requeues in-flight work;
 * the fixed-allocation loop (e11's baseline, accountant attached)
   reproduces ``repro``'s cycle records, ledgers and token streams exactly;
 * the RASK loop (xi 6, 120 s, the accountant attached, the port's random
   starts fed ``repro``'s draws): exploration plans equal within 1e-5, the
   post-exploration mean fulfillment within 0.03 (``test_torch_rask.py``'s
   tolerances), burn alerts equal and max burn within 1e-6 relative;
 * the bursty load patterns give ``repro``'s rps at every tick;
 * ``lm_profile`` is ``repro``'s surface once its two chip constants are
   set to ``repro``'s, and the port's constants are the H100's;
 * every entry point defaults to ``cuda`` and raises without it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.core import RASKAgent as JAgent
from repro.core import RaskConfig as JConfig
from repro.env import profiles as jax_profiles
from repro.env import workloads as jax_workloads
from repro.env.scenarios import real_serving_scenario as jax_scenario
from repro.models import build as jax_build
from repro.serve import engine as jax_engine
from repro.serve import run_serving_loop as jax_loop
from repro.serve import service as jax_service
from repro_torch.configs import get
from repro_torch.core import RASKAgent, RaskConfig
from repro_torch.core.platform import MUDAP
from repro_torch.env import bursty, lm_profile, real_serving_scenario
from repro_torch.env import profiles
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (DictCacheEngine, EngineConfig, Request,
                               ServedLMService, ServingEngine,
                               run_serving_loop, rung_config,
                               served_lm_profile)

torch.set_num_threads(1)
XI, LOOP_S, RASK_S = 6, 60.0, 120.0


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_get("gemma3-1b").smoke(), dtype="float32")
    jmodel = jax_build(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get("gemma3-1b").smoke(), dtype="float32")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, build(cfg), params, cfg


def _requests(cls, vocab, lengths, n, max_new, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid, rng.integers(0, vocab, lengths[rid % len(lengths)],
                                  dtype=np.int64).astype(np.int32),
                max_new_tokens=max_new) for rid in range(n)]


def _run(engine, reqs, max_steps=100):
    for r in reqs:
        engine.submit(r)
    for _ in range(max_steps):
        engine.step()
        if len(engine.completed) == len(reqs):
            break
    assert len(engine.completed) == len(reqs)
    return {r.rid: list(r.generated) for r in engine.completed}


def test_dict_engine_streams_match_repro_and_the_stacked_engine(models):
    """``repro``'s ``test_dict_and_stacked_streams_identical``, across both
    packages: mixed prompt lengths (exact-length prefills of 7 to 26
    tokens), 8 requests through 3 slots."""
    jmodel, jparams, model, params, cfg = models
    lengths, ecfg = [7, 13, 19, 26], dict(slots=3, max_seq=64, context=32,
                                          chips=4.0)
    want = _run(jax_engine.DictCacheEngine(jmodel, jparams,
                                           jax_engine.EngineConfig(**ecfg)),
                _requests(jax_engine.Request, cfg.vocab, lengths, 8, 5, 2))
    streams = {}
    for cls in (DictCacheEngine, ServingEngine):
        engine = cls(model, params, EngineConfig(**ecfg), device="cpu")
        streams[cls] = _run(engine, _requests(Request, cfg.vocab, lengths, 8,
                                              5, 2))
    assert streams[DictCacheEngine] == want
    assert streams[ServingEngine] == streams[DictCacheEngine]


def test_dict_engine_admission_and_truncation_match_repro(models):
    """Chips 0.5 (a 32-token budget a step) over prompts of 10 to 30
    tokens, context 12: the same prompts are admitted at the same steps,
    the longer ones truncated to their newest 12 tokens, with the same
    streams."""
    jmodel, jparams, model, params, cfg = models
    ecfg = dict(slots=4, max_seq=64, context=12, chips=0.5)
    engines = {"repro": jax_engine.DictCacheEngine(
                   jmodel, jparams, jax_engine.EngineConfig(**ecfg)),
               "port": DictCacheEngine(model, params, EngineConfig(**ecfg),
                                       device="cpu")}
    budget = int(0.5 * EngineConfig().tokens_per_chip_step)
    per_step, streams = {}, {}
    for name, eng in engines.items():
        cls = jax_engine.Request if name == "repro" else Request
        for r in _requests(cls, cfg.vocab, [10, 20, 30], 9, 3, 1):
            eng.submit(r)
        admitted, prev = [], 0
        for _ in range(60):
            eng.step()
            admitted.append(eng.prompt_tokens_in - prev)
            prev = eng.prompt_tokens_in
            if len(eng.completed) == 9:
                break
        per_step[name] = admitted
        streams[name] = {r.rid: list(r.generated) for r in eng.completed}
    assert per_step["port"] == per_step["repro"]
    assert max(per_step["port"]) <= budget
    assert engines["port"].prompt_tokens_in == 3 * (10 + 12 + 12)  # cut
    assert engines["port"].admissions == 9           # one prefill each
    assert len(engines["port"].step_s) == engines["port"].steps
    assert streams["port"] == streams["repro"]


def test_served_service_never_calls_profile_curve():
    """``repro``'s booby trap: the profile's ``tp_max`` raises, and a spy
    in its place sees no call through a full platform loop."""
    prof = served_lm_profile()
    with pytest.raises(RuntimeError, match="never be called"):
        prof.tp_max({"chips": 1.0, "context": 32.0, "rung": 3.0})
    calls = []
    spied = dataclasses.replace(prof,
                                tp_max=lambda p: calls.append(p) or 1.0)
    base = dataclasses.replace(get("gemma3-1b").smoke(), dtype="float32")
    svc = ServedLMService(build, base, profile=spied, slots=2, max_seq=64,
                          seed=0, rps=2.0, max_new_tokens=3, device="cpu")
    plat = MUDAP({"chips": 4.0})
    plat.register(svc.sid, spied.api, svc, list(spied.slos),
                  dict(spied.defaults))
    hist = run_serving_loop(plat, {str(svc.sid): lambda t: 2.0},
                            duration_s=12.0, cycle_s=10.0)
    assert calls == []
    m = plat.latest_metrics(str(svc.sid))
    assert m["throughput"] > 0.0            # real requests really completed
    assert m["step_latency_ms"] > 0.0       # measured wall-clock latency
    assert hist and hist[0].per_service


def test_served_service_elasticity_mapping():
    """chips/context/rung land on admission budget, truncation and the
    engine rung; a rung switch requeues in-flight work on the new engine,
    with its tokens dropped."""
    base = dataclasses.replace(get("gemma3-1b").smoke(), dtype="float32")
    svc = ServedLMService(build, base, slots=2, max_seq=64, seed=1,
                          rps=3.0, max_new_tokens=4, device="cpu")
    svc.advance(1.0)
    eng3 = svc._engine()
    assert eng3.cfg.rung == 3
    svc.apply("chips", 2.0)
    svc.apply("context", 12)
    assert eng3.cfg.chips == 2.0 and eng3.cfg.context == 12
    pending = list(eng3.active.values()) + list(eng3.queue)
    svc.apply("rung", 2)
    eng2 = svc._engine()
    assert eng2 is not eng3 and eng2.cfg.rung == 2
    assert eng2.model.cfg.d_model < eng3.model.cfg.d_model
    assert eng2.model.cfg.d_model == rung_config(base, 2).d_model == \
        jax_service.rung_config(base, 2).d_model
    assert len(eng3.active) == 0 and not eng3.queue   # old rung's work moved
    assert eng2.queue == pending and all(not r.generated for r in pending)
    svc.advance(2.0)
    assert svc.metrics()["rung"] == 2.0


def test_bursty_patterns_are_repros():
    for max_rps, seed in ((4.0, 10), (14.0, 11)):
        mine, ref = bursty(max_rps, 600.0, seed=seed), \
            jax_workloads.bursty(max_rps, 600.0, seed=seed)
        assert [mine(t) for t in range(0, 602)] == \
            [ref(t) for t in range(0, 602)]


def test_prompt_lengths_do_not_depend_on_the_vocab():
    """``advance`` draws a prompt's length and then its tokens from one
    generator: the lengths of the smoke vocab (256) and of gemma3-1b's
    (262144) are the same, so the loop schedules alike at either width."""
    lengths = {}
    for vocab in (256, 262144):
        rng = np.random.default_rng(0)
        lengths[vocab] = []
        for _ in range(200):
            n = int(np.clip(rng.normal(14.0, 4.0), 4, 64))
            rng.integers(0, vocab, n)
            lengths[vocab].append(n)
    assert lengths[256] == lengths[262144]


# -- the closed loop against repro --------------------------------------------

@pytest.fixture(scope="module")
def repro_rungs():
    """``repro``'s ``ServedLMService`` weights of every rung of the smoke
    ladder (``model.init(PRNGKey(17 + r))``), as numpy trees."""
    base = dataclasses.replace(jax_get("gemma3-1b").smoke(), dtype="float32")
    out = {}
    for r in (1, 2, 3, 4):
        model = jax_build(jax_service.rung_config(base, r))
        out[r] = jax.tree.map(np.asarray,
                              jax.jit(model.init)(jax.random.PRNGKey(17 + r)))
    return out


def _port_scenario(repro_rungs, duration):
    """The port's e11 scenario on the CPU, every service's rung ladder
    holding ``repro``'s weights."""
    out = real_serving_scenario(duration_s=duration, device="cpu")
    platform = out[0]
    for sid in platform.services():
        svc = platform.service(sid).backend
        for r, tree in repro_rungs.items():
            svc._params_by_rung[r] = params_from_numpy(
                rung_config(svc._base_cfg, r), tree)
    return out


def _ledgers(platform):
    return {sid: [(q.rid, len(q.prompt), list(q.generated))
                  for q in platform.service(sid).backend.ledger]
            for sid in platform.services()}


def _record(rec):
    return (rec.t, rec.fulfillment, rec.per_service, rec.rps, rec.explored,
            rec.alerts)


def test_fixed_loop_reproduces_repro(repro_rungs):
    """e11's fixed-allocation baseline (``agent=None``, the accountant
    attached), 60 s: every cycle record, every completed request's prompt
    and generated tokens, the drops and the accountant's alert log and
    burn states equal ``repro``'s."""
    jplat, jpat, jsids, _, jacct = jax_scenario(duration_s=LOOP_S)
    want = jax_loop(jplat, jpat, agent=None, duration_s=LOOP_S, cycle_s=10.0,
                    accountant=jacct)
    plat, pat, sids, _, acct = _port_scenario(repro_rungs, LOOP_S)
    got = run_serving_loop(plat, pat, agent=None, duration_s=LOOP_S,
                           cycle_s=10.0, accountant=acct)
    assert sids == jsids
    assert [_record(r) for r in got] == [_record(r) for r in want]
    assert len(got) == int(LOOP_S // 10)
    assert _ledgers(plat) == _ledgers(jplat)
    assert sum(len(v) for v in _ledgers(plat).values()) > 100
    assert [plat.service(s).backend.dropped for s in sids] == \
        [jplat.service(s).backend.dropped for s in sids]
    assert acct.alert_log == jacct.alert_log and acct.alert_log
    for sid in sids:
        a, b = acct.states[sid], jacct.states[sid]
        assert (a.bad_total, a.sample_total, a.firing, a.burn) == \
            (b.bad_total, b.sample_total, b.firing, b.burn)


class _Recorder:
    def _plan(self, a):
        self.plans.append(np.array(a, np.float32))
        return super()._plan(a)


class JaxAgent(_Recorder, JAgent):
    plans: list


class PortAgent(_Recorder, RASKAgent):
    """The port's agent, solving from ``repro``'s uniforms."""

    plans: list

    def _start_uniforms(self, seed):
        k_solve, _ = jax.random.split(jax.random.PRNGKey(seed))
        u = jax.random.uniform(k_solve, (max(self._budget_starts - 3, 0),
                                         self.problem.dim))
        return torch.from_numpy(np.array(u))


def test_rask_loop_tracks_repro(repro_rungs):
    """e11's RASK loop at xi 6 for 120 s, accountant attached, on both
    packages. Solved plans are not compared: a fit of 6-12 rows of 10
    terms is ill-conditioned and its two LU solves differ away from the
    data (ROADMAP Queue 3, recorded differences)."""
    jplat, jpat, _, jknow, jacct = jax_scenario(duration_s=RASK_S)
    jagent = JaxAgent(jplat, jknow, JConfig(resource="chips", xi=XI), seed=0)
    jagent.plans = []
    jagent.attach_accountant(jacct)
    jinfo = []
    want = jax_loop(jplat, jpat, agent=jagent, duration_s=RASK_S,
                    cycle_s=10.0,
                    on_cycle=lambda r: jinfo.append(jagent.last_decision))
    plat, pat, _, know, acct = _port_scenario(repro_rungs, RASK_S)
    agent = PortAgent(plat, know, RaskConfig(resource="chips", xi=XI),
                      seed=0, device="cpu")
    agent.plans = []
    agent.attach_accountant(acct)
    info = []
    got = run_serving_loop(plat, pat, agent=agent, duration_s=RASK_S,
                           cycle_s=10.0,
                           on_cycle=lambda r: info.append(agent.last_decision))
    assert [r.explored for r in got] == [r.explored for r in want] == \
        [True] * XI + [False] * (len(got) - XI)
    for a, b in zip(agent.plans[:XI], jagent.plans[:XI]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    post = np.mean([r.fulfillment for r in got[XI:]])
    ref = np.mean([r.fulfillment for r in want[XI:]])
    assert abs(post - ref) <= 0.03, (post, ref)
    assert [r.alerts for r in got] == [r.alerts for r in want]
    assert [i.burn_alerts for i in info] == [i.burn_alerts for i in jinfo]
    assert any(i.burn_alerts for i in info)
    np.testing.assert_allclose([i.max_burn for i in info],
                               [i.max_burn for i in jinfo], rtol=1e-6)
    mask = agent.problem.resource_mask
    assert all(a[mask].astype(np.float64).sum() <= 6.0 * (1 + 1e-6)
               for a in agent.plans)


# -- profiles, defaults, the launcher --------------------------------------------

def test_lm_profile_is_repros_surface(monkeypatch):
    """With the port's chip constants set to ``repro``'s, ``tp_max`` agrees
    over a grid of chips, context and (fractional) rung, analytic and
    calibrated; the API, SLOs and defaults are ``repro``'s."""
    monkeypatch.setattr(profiles, "PEAK_FLOPS", jax_profiles.PEAK_FLOPS)
    monkeypatch.setattr(profiles, "HBM_BW", jax_profiles.HBM_BW)
    calib = {1: 4000.0, 2: 2500.0, 3: 1700.0, 4: 1200.0}
    for n_params, cal in ((999_826_048, None), (32e9, None), (1e9, calib)):
        mine = lm_profile("lm", n_params, calibration=cal)
        ref = jax_profiles.lm_profile("lm", n_params, calibration=cal)
        for chips in (0.25, 1.0, 5.5, 16.0):
            for context in (2048.0, 8192.0, 32768.0):
                for rung in (1.0, 1.5, 2.0, 3.25, 4.0):
                    p = {"chips": chips, "context": context, "rung": rung}
                    assert mine.tp_max(p) == pytest.approx(ref.tp_max(p),
                                                           rel=1e-12)
        assert [dataclasses.astuple(q) for q in mine.slos] == \
            [dataclasses.astuple(q) for q in ref.slos]
        assert mine.defaults == ref.defaults
        assert [(p.name, p.min_value, p.max_value, p.step)
                for p in mine.api.parameters] == \
            [(p.name, p.min_value, p.max_value, p.step)
             for p in ref.api.parameters]


def test_lm_profile_rates_an_h100():
    """The H100 SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3;
    gemma3-1b's decode rate per card is the weight-streaming bound."""
    assert profiles.PEAK_FLOPS == 989e12 and profiles.HBM_BW == 3.35e12
    n = 999_826_048
    want = min(989e12 * 0.5 / (2 * n), 3.35e12 * 0.7 * 32 / (2 * n))
    assert profiles._lm_rate_tokens_per_chip(n, 4.0) == pytest.approx(want)


def test_entry_points_default_to_cuda_and_raise_without_it(models,
                                                            monkeypatch):
    _, _, model, params, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = dataclasses.replace(get("gemma3-1b").smoke(), dtype="float32")
    for make in (lambda: DictCacheEngine(model, params, EngineConfig()),
                 lambda: ServedLMService(build, base),
                 lambda: real_serving_scenario(duration_s=10.0)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--engine", "dict", "--requests", "1"])


def test_dict_engine_refuses_params_on_another_device(models):
    _, _, model, params, _ = models
    with pytest.raises(ValueError, match="params on"):
        DictCacheEngine(model, {**params, "embed": params["embed"].to("meta")},
                        EngineConfig(), device="cpu")


def test_launcher_serves_with_the_dict_engine():
    engine = launch_serve.main(["--device", "cpu", "--engine", "dict",
                                "--requests", "3", "--prompt-len", "20",
                                "--max-new", "4"])
    assert isinstance(engine, DictCacheEngine)
    assert len(engine.completed) == 3
    assert all(len(r.generated) == 4 for r in engine.completed)
