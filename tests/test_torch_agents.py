"""The port's e3 baselines (src/repro_torch/core/agents) against
``repro``'s, on the CPU.

* VPA: the three band cases of ``tests/test_agents.py`` as port cases, and
  a closed loop on the paper triple under e3's seeded bursty trace (300 s)
  whose plans, applied assignments and fulfilment equal ``repro``'s cycle
  by cycle (the VPA is host arithmetic on the same telemetry: exact).
* DQN, from ``repro``'s weights carried across with
  ``dqn_params_from_numpy`` (the port draws its own initial weights from a
  ``torch.Generator``): Q-values within 1e-5, and one TD step's loss and
  updated weights within 1e-5 (float32 on both sides; sums in another
  order); a short pretrain (``train_steps=200`` a service) takes the
  same actions at every step (the epsilon-greedy draws and the replay
  batches come from the same numpy rng stream) and ends with losses
  within 1e-5 relative (one run: 4.4e-7 after 137 TD steps); the
  pretrained agents decide the same plan. The target network is a copy:
  a TD step leaves it where it was, and a sync copies without aliasing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PolynomialModel as JModel
from repro.core.agents import DQNAgent as JDQN
from repro.core.agents import DQNConfig as JDQNConfig
from repro.core.agents import VPAAgent as JVPA
from repro.core.agents.dqn import _mlp_apply, _td_step
from repro.core.elasticity import ServiceId as JSid
from repro.core.platform import MUDAP as JMUDAP
from repro.core.regression import fit_polynomial as j_fit
from repro.env import EdgeEnvironment as JEnv
from repro.env import paper_profiles as j_profiles
from repro.env.profiles import QR_PROFILE as J_QR
from repro.env.workloads import bursty as j_bursty
from repro.env.workloads import constant as j_constant
from repro_torch.core import PolynomialModel
from repro_torch.core.agents import (DQNAgent, DQNConfig, VPAAgent,
                                     dqn_params_from_numpy)
from repro_torch.core.elasticity import ServiceId
from repro_torch.core.platform import MUDAP
from repro_torch.env import EdgeEnvironment, bursty, constant, paper_profiles
from repro_torch.env.profiles import QR_PROFILE

torch.set_num_threads(1)
CPU = torch.device("cpu")


class _Stub:
    def __init__(self, util):
        self.util = util
        self.applied = {}

    def apply(self, param, value):
        self.applied[param] = value

    def metrics(self):
        return {"cpu_utilization": self.util,
                "rps": 10.0, "completion": 1.0, **self.applied}


@pytest.mark.parametrize("util,cores", [(0.99, 4.25), (0.2, 3.75),
                                        (0.9, 4.0)])
def test_vpa_band(util, cores):
    """``tests/test_agents.py``'s scale-up, scale-down and hold cases."""
    m = MUDAP({"cores": 8.0})
    m.register(ServiceId("e", "qr-detector", "c0"), QR_PROFILE.api,
               _Stub(util), list(QR_PROFILE.slos),
               {"cores": 4.0, "data_quality": 500})
    for t in range(1, 7):
        m.scrape(float(t))
    VPAAgent(m).cycle(6.0)
    assert m.assignment("e/qr-detector/c0")["cores"] == cores


def _e3_bursty(pkg):
    b, c = (j_bursty, j_constant) if pkg == "repro" else (bursty, constant)
    return {"qr-detector": b(100.0, duration_s=300.0, seed=0),
            "cv-analyzer": b(10.0, duration_s=300.0, seed=100),
            "pc-visualizer": c(50.0)}


def test_vpa_closed_loop_is_repros():
    jenv = JEnv(list(j_profiles().values()), {"cores": 8.0},
                patterns=_e3_bursty("repro"), seed=0)
    env = EdgeEnvironment(list(paper_profiles().values()), {"cores": 8.0},
                          patterns=_e3_bursty("port"), seed=0)
    want = jenv.run(JVPA(jenv.platform), duration_s=300.0)
    got = env.run(VPAAgent(env.platform), duration_s=300.0)
    assert len(got) == len(want) == 30
    for g, w in zip(got, want):
        assert g.fulfillment == w.fulfillment
        assert g.per_service == w.per_service and g.rps == w.rps
        assert g.receipt.applied() == w.receipt.applied()


def _jnet_params(jnet):
    return [(np.array(w), np.array(b)) for w, b in jnet.params]


def _carry(agent, jagent):
    """Put ``repro``'s initial weights into the port's networks."""
    for sid, net in agent.nets.items():
        net.set_params(dqn_params_from_numpy(
            _jnet_params(jagent.nets[sid]), agent.device))


def _agents(steps=200):
    jenv = JEnv(list(j_profiles().values()), {"cores": 8.0}, seed=0)
    env = EdgeEnvironment(list(paper_profiles().values()), {"cores": 8.0},
                          seed=0)
    jagent = JDQN(jenv.platform, JDQNConfig(train_steps=steps), seed=0)
    agent = DQNAgent(env.platform, DQNConfig(train_steps=steps), seed=0,
                     device=CPU)
    _carry(agent, jagent)
    return jenv, env, jagent, agent


def test_dqn_q_values_from_carried_weights():
    _, _, jagent, agent = _agents()
    rng = np.random.default_rng(3)
    for sid, net in agent.nets.items():
        jnet = jagent.nets[sid]
        for _ in range(8):
            s = rng.uniform(0, 1, net.state_dim).astype(np.float32)
            np.testing.assert_allclose(net.q_values(s), jnet.q_values(s),
                                       rtol=1e-5, atol=1e-5)
        # and the transpose is where it belongs: (out, in) in the module
        w0 = _jnet_params(jnet)[0][0]
        assert net.net[0].weight.shape == (w0.shape[1], w0.shape[0])


def test_dqn_td_step_from_carried_weights():
    _, _, jagent, agent = _agents()
    sid = next(iter(agent.nets))
    net, jnet = agent.nets[sid], jagent.nets[sid]
    rng = np.random.default_rng(5)
    B = 64
    s = rng.uniform(0, 1, (B, net.state_dim)).astype(np.float32)
    a = rng.integers(net.n_actions, size=B)
    r = rng.uniform(0, 1, B).astype(np.float32)
    s2 = rng.uniform(0, 1, (B, net.state_dim)).astype(np.float32)
    d = np.zeros(B, np.float32)
    # a target that differs from the online network
    jtarget = [(w * 0.9, b + 0.01) for w, b in jnet.params]
    net.target = dqn_params_from_numpy(
        [(np.array(w), np.array(b)) for w, b in jtarget])
    params, opt_state = jnet.params, jnet.opt_state
    for _ in range(2):                  # two steps: the bias corrections
        params, opt_state, jloss = _td_step(
            params, jtarget, opt_state,
            tuple(jnp.asarray(x) for x in (s, a, r, s2, d)), 0.9,
            jnp.float32(3e-4))
        loss = net.td_step(*(torch.from_numpy(np.asarray(x)) for x in
                             (s, a.astype(np.int64), r, s2, d)), 3e-4)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                                   atol=1e-5)
    for lin, (w, b) in zip([m for m in net.net if hasattr(m, "weight")],
                           params):
        np.testing.assert_allclose(lin.weight.detach().numpy().T,
                                   np.array(w), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(lin.bias.detach().numpy(), np.array(b),
                                   rtol=1e-5, atol=1e-5)
    q = net.net(torch.from_numpy(s)).detach().numpy()
    np.testing.assert_allclose(q, np.array(_mlp_apply(params, s)),
                               rtol=1e-5, atol=1e-5)


def test_dqn_target_is_a_copy():
    _, _, _, agent = _agents()
    net = next(iter(agent.nets.values()))
    before = [p.detach().clone() for p in net.target.parameters()]
    rng = np.random.default_rng(1)
    B = 8
    net.td_step(torch.from_numpy(rng.random((B, net.state_dim),
                                            np.float32)),
                torch.zeros(B, dtype=torch.int64),
                torch.ones(B), torch.from_numpy(rng.random(
                    (B, net.state_dim), np.float32)), torch.zeros(B), 1e-2)
    for t, b, p in zip(net.target.parameters(), before,
                       net.net.parameters()):
        assert torch.equal(t, b) and not torch.equal(t, p)
    net.sync_target()
    for t, p in zip(net.target.parameters(), net.net.parameters()):
        assert torch.equal(t, p) and t.data_ptr() != p.data_ptr()


def _tp_models(rng):
    """A degree-2 tp_max model per service type fitted by ``repro`` to its
    hidden surface, and the port's model with the same weights."""
    jm, tm, feats = {}, {}, {}
    for p in j_profiles().values():
        names = list(p.api.names)
        f = list(p.knowledge["tp_max"])
        lo = np.asarray([p.api.parameter(n).min_value for n in names])
        hi = np.asarray([p.api.parameter(n).max_value for n in names])
        X = rng.uniform(lo, hi, (40, len(names))).astype(np.float32)
        Y = np.asarray([p.tp_max(dict(zip(names, x))) for x in X],
                       np.float32)
        Xf = X[:, [names.index(n) for n in f]]
        m = j_fit(Xf, Y, 2, x_scale=Xf.max(0))
        jm[p.type] = m
        tm[p.type] = PolynomialModel(torch.from_numpy(np.array(m.w)),
                                     m.exponents, m.x_scale, m.degree)
        feats[p.type] = f
    return jm, tm, feats


def _recording(agent):
    """Record every action the pretrain applies, per service."""
    actions = {sid: [] for sid in agent.nets}
    for sid, net in agent.nets.items():
        orig = net.apply_action

        def apply_action(p, a, sid=sid, orig=orig):
            actions[sid].append(int(a))
            return orig(p, a)
        net.apply_action = apply_action
    return actions


def test_dqn_pretrain_from_carried_weights_and_decide():
    jenv, env, jagent, agent = _agents(steps=200)
    jm, tm, feats = _tp_models(np.random.default_rng(0))
    sids = list(agent.nets)
    type_of = {s: s.split("/")[1] for s in sids}
    rps = {s: 20.0 for s in sids}
    jact, act = _recording(jagent), _recording(agent)
    jlosses = jagent.pretrain({s: jm[type_of[s]] for s in sids}, rps,
                              {s: feats[type_of[s]] for s in sids})
    losses = agent.pretrain({s: tm[type_of[s]] for s in sids}, rps,
                            {s: feats[type_of[s]] for s in sids})
    for s in sids:
        assert act[s] == jact[s]
        assert np.isfinite(losses[s])
        assert abs(losses[s] - jlosses[s]) <= 1e-5 * abs(jlosses[s]), \
            (losses, jlosses)
    jenv.run(JVPA(jenv.platform), duration_s=20.0)
    obs = jagent.observe(jenv.t)
    assert agent.decide(obs).assignments == jagent.decide(obs).assignments
