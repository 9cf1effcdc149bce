"""The port's metric registry and Prometheus exposition
(src/repro_torch/obs/registry.py, prometheus.py) against ``repro``'s.

* ``render`` of ``golden_signals`` over the same platform telemetry, the
  same accountant state and the same decide state equals ``repro``'s line
  for line (help texts, types, label sets, values; both packages' floats
  print through ``repr``), for every scrape at which the accountant
  updates.
* Label values escape backslash, newline and double quote, HELP text
  backslash and newline, as ``repro`` escapes them; non-finite values
  print as ``NaN``/``+Inf``/``-Inf``.
* ``MetricsServer`` on 127.0.0.1, port 0: a GET of ``/metrics`` returns
  ``render``'s text with the 0.0.4 content type; another path is a 404.
* ``golden_signals`` over the port's own RASK agent (the paper triple on
  the CPU, the accountant attached) reads every ``DecisionInfo`` field it
  exports.
"""
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import DecisionInfo as JInfo
from repro_torch import obs
from repro_torch.core import DecisionInfo, RASKAgent, RaskConfig
from repro_torch.env import (EdgeEnvironment, paper_knowledge,
                             paper_profiles, sim_slo_budget)
from test_torch_obs import _budgets, _platform, _scrapes

torch.set_num_threads(1)


def _complete_scrapes(seed):
    """``test_torch_obs``'s seeded scrapes with every completion metric
    present: both packages' service collector reads it unguarded (a
    service with SLOs and no completion raises ``KeyError`` in both)."""
    for t, metrics in _scrapes(seed):
        yield t, {sid: {"completion": 1.0, **m} for sid, m in metrics.items()}


def _agent_state(info_cls):
    return types.SimpleNamespace(
        last_decision=info_cls(explored=False, runtime_s=0.0123,
                               score=2.75, pgd_starts=6, pgd_iters=32,
                               score_starts=4, score_iters=16,
                               burn_alerts=1, max_burn=3.5),
        moves_total=2, compile_s_total=1.25)


@pytest.mark.parametrize("override", [False, True])
def test_render_is_repros_line_for_line(override):
    sides = {}
    for pkg, m, info in (("repro", jobs, JInfo), ("port", obs, DecisionInfo)):
        platform, stubs = _platform(pkg)
        default, overrides = _budgets(pkg, override)
        acct = m.SLOAccountant(platform, default, overrides=overrides)
        reg = m.MetricRegistry()
        m.golden_signals(reg, platform, accountant=acct,
                         agent=_agent_state(info))
        sides[pkg] = (platform, stubs, acct, reg, m)
    checked = 0
    for t, metrics in _complete_scrapes(seed=7):
        texts = {}
        for pkg, (platform, stubs, acct, reg, m) in sides.items():
            for sid, vals in metrics.items():
                stubs[sid].values = vals
            platform.scrape(t)
            if int(t) % 50 == 0:
                acct.update(t)
                texts[pkg] = m.render(reg)
        if texts:
            assert texts["port"].splitlines() == texts["repro"].splitlines()
            checked += 1
    text = texts["port"]
    assert checked == 8
    for family in ("repro_service_rps", "repro_service_fulfillment",
                   "repro_slo_budget_consumed", "repro_slo_alert_firing",
                   "repro_decide_us", "repro_decide_compile_seconds_total"):
        assert f"# TYPE {family} " in text
    assert obs.snapshot(sides["port"][3]) == text


def test_label_and_help_escaping_is_repros():
    texts = []
    for m in (jobs, obs):
        reg = m.MetricRegistry()
        g = reg.gauge("x_gauge", 'help with \\ and\nnewline and "quote"')
        g.set(1.5, service='a"b\\c\nd')
        g.set(float("nan"), service="nan")
        g.set(float("inf"), service="inf")
        g.set(float("-inf"), service="ninf")
        c = reg.counter("x_total")
        c.inc()
        c.inc(2.0)
        with pytest.raises(ValueError):
            reg.counter("x_gauge")
        texts.append(m.render(reg))
    assert texts[1] == texts[0]
    text = texts[1]
    assert '# HELP x_gauge help with \\\\ and\\nnewline and "quote"' in text
    assert 'x_gauge{service="a\\"b\\\\c\\nd"} 1.5' in text
    assert 'x_gauge{service="nan"} NaN' in text
    assert 'x_gauge{service="inf"} +Inf' in text
    assert 'x_gauge{service="ninf"} -Inf' in text
    assert "x_total 3.0" in text


def test_metrics_server_round_trip():
    platform, stubs = _platform("port")
    default, _ = _budgets("port", False)
    acct = obs.SLOAccountant(platform, default)
    reg = obs.MetricRegistry()
    obs.golden_signals(reg, platform, accountant=acct,
                       agent=_agent_state(DecisionInfo))
    for t, metrics in _complete_scrapes(seed=1):
        for sid, vals in metrics.items():
            stubs[sid].values = vals
        platform.scrape(t)
        if t >= 60:
            break
    acct.update(60.0)
    with obs.MetricsServer(reg, port=0) as srv:
        assert srv.host == "127.0.0.1" and srv.port > 0
        url = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            body = r.read().decode()
            ctype = r.headers["Content-Type"]
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(url + "/nope", timeout=10)
        assert err.value.code == 404
    assert srv._httpd is None and srv._thread is None
    assert body == obs.render(reg)
    assert ctype == "text/plain; version=0.0.4; charset=utf-8"
    assert "repro_slo_budget_consumed" in body


def test_golden_signals_read_the_ports_agent():
    env = EdgeEnvironment(list(paper_profiles().values()), {"cores": 8.0},
                          seed=0)
    agent = RASKAgent(env.platform, paper_knowledge(),
                      RaskConfig(xi=8, eta=0.0), device="cpu")
    acct = obs.SLOAccountant(env.platform, sim_slo_budget())
    agent.attach_accountant(acct)
    reg = obs.MetricRegistry()
    obs.golden_signals(reg, env.platform, accountant=acct, agent=agent)
    env.run(agent, duration_s=120.0)
    text = obs.render(reg)
    info = agent.last_decision
    assert not info.explored
    got = {line.split(" ")[0]: float(line.split(" ")[1])
           for line in text.splitlines() if line.startswith("repro_decide")}
    assert got["repro_decide_us"] == pytest.approx(info.runtime_s * 1e6)
    assert got["repro_decide_score"] == pytest.approx(info.score)
    assert got["repro_decide_pgd_iters"] == info.pgd_iters == 32
    assert got["repro_decide_moves_total"] == agent.moves_total
    sids = env.platform.services()
    assert all(f'repro_service_fulfillment{{service="{s}"}}' in text
               for s in sids)
    assert all(np.isfinite(v) for v in got.values())
