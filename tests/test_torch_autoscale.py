"""The port's control-plane CLI (``repro_torch/launch/autoscale.py``) and
its two fleet launchers (``launch/fleet_autoscale.py``,
``launch/hetero_fleet.py``) against ``repro``'s, on the CPU.

Both CLIs run the same seeded worlds: three LM services (gemma3-1b,
qwen2-moe-a2.7b, mamba2-370m) on 16 chips for 5 simulated minutes, and 9
of them on 3 hosts with the placement stage every 3 cycles and the SLO
accountant. The port's LM surfaces are rated by the H100 data sheet;
here they take ``repro``'s two chip constants, as in
``tests/test_torch_served.py``, so the two packages scale the same
services.

 * the exploration plans (the first xi = 20 cycles, drawn from the numpy
   rng) equal ``repro``'s within 1e-5, parameter by parameter;
 * the post-exploration mean fulfilment is no worse than ``repro``'s by
   more than 0.03 (the bar of ``tests/test_torch_failover.py``; the
   solved plans part from ``repro``'s random starts, ``torch.Generator``
   against ``jax.random``);
 * ``--dump-metrics`` writes the metric families ``repro``'s writes;
 * ``--shard`` resolves as ``repro``'s ``resolve_shard`` does on one
   device: every count runs, and ``--shard 2`` and ``4`` print what
   ``--shard 1`` prints; a count that resolves to several cards raises
   naming the ROADMAP item for them;
 * the fleet launchers run on the CPU, and every launcher runs on the
   card unless told otherwise, raising when there is none.
"""
import re

import numpy as np
import pytest
import torch

from repro.env import profiles as jax_profiles
from repro.launch import autoscale as jax_autoscale
from repro_torch.env import profiles
from repro_torch.launch import autoscale, fleet_autoscale, hetero_fleet, \
    serve

torch.set_num_threads(1)
XI = 20
MODES = {"single": ["--minutes", "5"],
         "fleet": ["--minutes", "5", "--hosts", "3", "--replicas", "3",
                   "--rebalance-every", "3", "--slo-burn"]}


@pytest.fixture(scope="module", params=sorted(MODES))
def runs(request, tmp_path_factory):
    argv = MODES[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    jhist = jax_autoscale.main(argv + ["--dump-metrics",
                                       str(tmp / "repro.prom")])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiles, "PEAK_FLOPS", jax_profiles.PEAK_FLOPS)
        mp.setattr(profiles, "HBM_BW", jax_profiles.HBM_BW)
        hist = autoscale.main(argv + ["--device", "cpu", "--dump-metrics",
                                      str(tmp / "port.prom")])
    return dict(mode=request.param, hist=hist, jhist=jhist,
                prom=(tmp / "port.prom").read_text(),
                jprom=(tmp / "repro.prom").read_text())


def _requested(rec):
    return sorted((o.sid, o.param, o.requested) for o in rec.receipt.outcomes)


def test_exploration_plans_are_repros(runs):
    hist, jhist = runs["hist"], runs["jhist"]
    assert len(hist) == len(jhist) == 30
    assert [h.explored for h in hist] == [h.explored for h in jhist]
    assert sum(h.explored for h in hist) == XI
    for h, j in zip(hist[:XI], jhist[:XI]):
        got, want = _requested(h), _requested(j)
        assert [g[:2] for g in got] == [w[:2] for w in want]
        np.testing.assert_allclose([g[2] for g in got],
                                   [w[2] for w in want], rtol=1e-5,
                                   atol=1e-5)


def test_post_exploration_fulfillment_tracks_repro(runs):
    post = np.mean([h.fulfillment for h in runs["hist"][XI:]])
    jpost = np.mean([h.fulfillment for h in runs["jhist"][XI:]])
    assert post >= jpost - 0.03, (post, jpost)
    for h in runs["hist"]:
        assert 0.0 <= h.fulfillment <= 1.0


def _families(text):
    return sorted(re.findall(r"^# TYPE (\S+) ", text, re.M))


def test_dump_metrics_has_repros_families(runs):
    assert _families(runs["prom"]) == _families(runs["jprom"])
    assert "repro_service_fulfillment" in _families(runs["prom"])
    if runs["mode"] == "fleet":
        assert "repro_slo_budget_consumed" in _families(runs["prom"])


def test_summary_lines(capsys):
    autoscale.main(["--device", "cpu", "--minutes", "2", "--hosts", "3",
                    "--replicas", "3", "--slo-burn", "--shard", "off"])
    out = capsys.readouterr().out
    assert "services=9 hosts=3 cycles=12" in out
    assert "slo: budget consumed=" in out


@pytest.mark.parametrize("shard", ["auto", "off", "1"])
def test_shard_on_one_card_is_accepted(shard):
    assert autoscale.one_card(shard, torch.device("cpu")) == 1


def test_shard_over_several_cards_names_the_mesh_item(monkeypatch):
    """Where several cards are present, a count above 1 asks for them:
    spreading the solve over cards is ROADMAP item 31."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError, match="item 31"):
        autoscale.one_card("2", torch.device("cuda"))
    assert autoscale.one_card("1", torch.device("cuda")) == 1
    assert autoscale.one_card("off", torch.device("cuda")) == 1


@pytest.mark.parametrize("shard", [True, False, None, "auto", "off", "0",
                                   0, 1, 2, 4, "4"])
def test_resolve_shard_matches_repro_on_one_device(shard):
    from repro.core.solver import resolve_shard as jax_resolve_shard
    from repro_torch.core.solver import resolve_shard
    want = jax_resolve_shard(False if shard == "off" else shard)
    assert resolve_shard(shard, torch.device("cpu")) == want == 1


def test_shard_counts_above_one_print_what_shard_1_prints(capsys):
    """``repro`` caps the count at the devices present, so on one device
    ``--shard 2`` and ``--shard 4`` run the same solve as ``--shard 1``."""
    outs = {}
    for shard in ("1", "2", "4"):
        autoscale.main(["--device", "cpu", "--minutes", "2", "--shard",
                        shard])
        outs[shard] = capsys.readouterr().out
    assert "cycles=" in outs["1"]
    assert outs["2"] == outs["1"] and outs["4"] == outs["1"]


def test_lm_services_read_the_ported_registry():
    names = [p.type for p in autoscale.lm_services()]
    assert names == ["gemma3-1b", "qwen2-moe-a2.7b", "mamba2-370m"]
    assert [p.default_rps for p in autoscale.lm_services()] == [12.0, 6.0,
                                                                20.0]


def test_fleet_autoscale_runs_on_cpu(capsys):
    assert fleet_autoscale.main(["--device", "cpu", "--seconds",
                                 "300"]) == 0
    out = capsys.readouterr().out
    assert "9 services on 3 hosts" in out
    assert "post-exploration mean fulfillment" in out
    assert len(re.findall(r"edge-\d: [\d.]+/8.00 cores across 3", out)) == 3


def test_hetero_fleet_runs_on_cpu(capsys):
    assert hetero_fleet.main(["--device", "cpu", "--seconds", "300"]) == 0
    out = capsys.readouterr().out
    for text in ("camera-0:  2.0 cores, 1 services -> bucket (1, 1)",
                 "gateway-0: 16.0 cores, 6 services -> bucket (8, 8)",
                 "post-exploration mean fulfillment", "rebalance:"):
        assert text in out, out


@pytest.mark.parametrize("main,argv", [
    (autoscale.main, ["--minutes", "1"]),
    (fleet_autoscale.main, ["--seconds", "10"]),
    (hetero_fleet.main, ["--seconds", "10"]),
    (serve.main, ["--arch", "qwen2-moe-a2.7b", "--requests", "1"])])
def test_launchers_default_to_the_card(monkeypatch, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
