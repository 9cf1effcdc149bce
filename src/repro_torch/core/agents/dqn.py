"""DQN baseline — paper §V-C3 (the port of ``repro/core/agents/dqn.py``).

"Approximates Q-values for discrete state-action pairs. To support
service-specific scaling policies, services are modeled through separate
DQNs. Models are pre-trained jointly within a shared environment, which,
given an action, estimates the expected state and reward (i.e., SLO
fulfillment) according to RASK's regression model. The DQN agent has access
to all available elasticity dimensions; however, to decrease the action
space, it only infers a single action per service."

Per-service MLP Q-network (an ``nn.Module``, [state, 64, 64, actions] with
ReLU, on the agent's device: ``cuda`` unless the caller asks for the CPU),
replay buffer, target network, epsilon-greedy pre-training inside a
model-based environment driven by a fitted ``PolynomialModel`` (the same
surfaces RASK learns). Actions are coarse-grained (one ±step move of one
parameter, or no-op) — deliberately discrete, which is exactly the
limitation (3) the paper attributes to RL baselines.

As in ``repro``: the epsilon-greedy draws and the replay batches come from
the agent's ``np.random.default_rng(seed)`` in the same order, and the TD
step keeps ``repro``'s arithmetic (``_td_step``), its "simple Adam"
written out (m <- 0.9 m + 0.1 g, v <- 0.999 v + 0.001 g^2, bias
corrections with the step count, eps = 1e-8 outside the square root). The
target network is a copy, refreshed in place every ``target_sync`` steps
(``repro``'s ``net.target = net.params`` aliases an immutable pytree; with
tensors updated in place an alias would follow every step). The initial
weights come from a ``torch.Generator`` seeded like ``repro``'s key: they
differ from ``jax.random``'s; ``dqn_params_from_numpy`` carries
``repro``'s weights across.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ...device import resolve_device, upload
from ..api import DecisionInfo, PlanningAgent, ScalingPlan
from ..elasticity import ApiDescription
from ..platform import MUDAP
from ..regression import PolynomialModel
from ..slo import SLO
from ..solver import COMPLETION


@dataclasses.dataclass
class DQNConfig:
    hidden: int = 64
    lr: float = 3e-4
    gamma: float = 0.9
    eps_start: float = 1.0
    eps_end: float = 0.05
    train_steps: int = 3000
    batch_size: int = 64
    buffer: int = 10000
    target_sync: int = 200
    episode_len: int = 40
    resource: str = "cores"


def _mlp(sizes: Sequence[int]) -> nn.Sequential:
    layers = []
    for i in range(len(sizes) - 1):
        layers.append(nn.Linear(sizes[i], sizes[i + 1]))
        if i < len(sizes) - 2:
            layers.append(nn.ReLU())
    return nn.Sequential(*layers)


def _linears(module: nn.Sequential):
    return [m for m in module if isinstance(m, nn.Linear)]


def _mlp_init(module: nn.Sequential, seed: int) -> None:
    """He-normal weights (std sqrt(2 / fan_in)) and zero biases, drawn on
    the CPU from a ``torch.Generator`` seeded with ``seed`` (``repro``'s
    ``_mlp_init`` from ``PRNGKey(seed)``), so the card and the CPU start
    from the same weights."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for lin in _linears(module):
            fan_in, fan_out = lin.in_features, lin.out_features
            w = torch.randn((fan_in, fan_out), generator=gen) * \
                float(np.sqrt(np.float32(2.0) / np.float32(fan_in)))
            lin.weight.copy_(w.T)
            lin.bias.zero_()


def dqn_params_from_numpy(params, device=None) -> nn.Sequential:
    """``repro``'s ``[(w, b), ...]`` (``w`` (in, out), used as ``x @ w``)
    as the port's MLP on ``device`` (the CPU by default): ``nn.Linear``
    keeps its weight as (out, in), so ``w`` goes in transposed."""
    sizes = [np.shape(params[0][0])[0]] + [np.shape(w)[1] for w, _ in params]
    module = _mlp(sizes)
    with torch.no_grad():
        for lin, (w, b) in zip(_linears(module), params):
            lin.weight.copy_(torch.from_numpy(np.array(w, np.float32)).T)
            lin.bias.copy_(torch.from_numpy(np.array(b, np.float32)))
    dev = torch.device("cpu") if device is None else torch.device(device)
    return module.to(dev)


class ServiceDQN:
    """One per-service Q-network over the discrete move-one-knob action set,
    on ``device``."""

    def __init__(self, api: ApiDescription, slos: Sequence[SLO],
                 cfg: DQNConfig, seed: int, device: torch.device):
        self.api = api
        self.slos = list(slos)
        self.cfg = cfg
        self.device = device
        self.names = api.names
        self.lo = np.asarray([p.min_value for p in api.parameters], np.float32)
        self.hi = np.asarray([p.max_value for p in api.parameters], np.float32)
        self.steps = np.asarray(
            [p.step if p.step else (p.max_value - p.min_value) / 10.0
             for p in api.parameters], np.float32)
        self.n_actions = 2 * len(self.names) + 1
        self.state_dim = len(self.names) + 2          # params + rps + completion
        module = _mlp([self.state_dim, cfg.hidden, cfg.hidden, self.n_actions])
        _mlp_init(module, seed)
        self.set_params(module.to(device))

    def set_params(self, module: nn.Sequential) -> None:
        """Take ``module`` as the online network: the target becomes a copy
        of it and the Adam state starts over (``repro``'s construction)."""
        self.net = module.to(self.device)
        self.target = copy.deepcopy(self.net)
        self.target.requires_grad_(False)
        self.opt_m = [torch.zeros_like(p) for p in self.net.parameters()]
        self.opt_v = [torch.zeros_like(p) for p in self.net.parameters()]
        self.opt_t = 0

    def sync_target(self) -> None:
        """Copy the online weights into the target network, in place."""
        with torch.no_grad():
            for t, p in zip(self.target.parameters(), self.net.parameters()):
                t.copy_(p)

    def norm_state(self, p: np.ndarray, rps: float, completion: float):
        x = (p - self.lo) / np.maximum(self.hi - self.lo, 1e-9)
        return np.concatenate([x, [rps / 100.0, completion]]).astype(np.float32)

    def apply_action(self, p: np.ndarray, action: int) -> np.ndarray:
        p = p.copy()
        if action < 2 * len(self.names):
            idx, direction = divmod(action, 2)
            p[idx] += self.steps[idx] * (1.0 if direction == 0 else -1.0)
        return np.clip(p, self.lo, self.hi)

    def q_values(self, state: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            x = upload(np.asarray(state, np.float32)[None], self.device)
            return self.net(x)[0].cpu().numpy()

    def td_step(self, s, a, r, s2, done, lr: float) -> torch.Tensor:
        """One TD step on a batch of tensors on the device (``repro``'s
        ``_td_step``): the squared TD error against the target network's
        greedy value, its gradient by autograd, and the simple Adam update
        in place. Returns the loss (a 0-d tensor; nothing waits)."""
        q = self.net(s)
        q_sa = torch.gather(q, 1, a[:, None])[:, 0]
        with torch.no_grad():
            q2 = self.target(s2).amax(dim=1)
            tgt = r + self.cfg.gamma * (1.0 - done) * q2
        loss = torch.mean((q_sa - tgt) ** 2)
        params = list(self.net.parameters())
        grads = torch.autograd.grad(loss, params)
        self.opt_t += 1
        t = np.float32(self.opt_t)
        bc1 = float(np.float32(1.0) - np.float32(0.9) ** t)
        bc2 = float(np.float32(1.0) - np.float32(0.999) ** t)
        lr = float(np.float32(lr))
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, self.opt_m, self.opt_v):
                m.copy_(0.9 * m + 0.1 * g)
                v.copy_(0.999 * v + 0.001 * g * g)
                p.copy_(p - lr * (m / bc1) / (torch.sqrt(v / bc2) + 1e-8))
        return loss.detach()

    def reward(self, p: np.ndarray, tp_max: float, rps: float) -> float:
        """Weighted SLO fulfillment of the estimated next state (Eq. 8 terms)."""
        num = den = 0.0
        for q in self.slos:
            if q.metric in self.names:
                phi = min(p[self.names.index(q.metric)] / q.target, 1.0)
            elif q.metric == COMPLETION:
                phi = min(tp_max / max(rps * q.target, 1e-9), 1.0)
            else:
                continue
            num += q.weight * phi
            den += q.weight
        return num / max(den, 1e-9)


class DQNAgent(PlanningAgent):
    """Pre-trained per-service DQNs acting greedily on the MUDAP platform;
    the networks live on ``device`` (``cuda`` unless the caller asks for
    the CPU)."""

    name = "dqn"

    def __init__(self, platform: MUDAP, cfg: Optional[DQNConfig] = None,
                 seed: int = 0, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.platform = platform
        self.cfg = cfg if cfg is not None else DQNConfig()
        self.rng = np.random.default_rng(seed)
        self.rounds = -1
        self.nets: Dict[str, ServiceDQN] = {}
        for i, sid in enumerate(platform.services()):
            svc = platform.service(sid)
            self.nets[sid] = ServiceDQN(svc.api, svc.slos, self.cfg, seed + i,
                                        self.device)

    # -- offline pre-training in the regression-model environment --------------
    def pretrain(self, models: Mapping[str, PolynomialModel],
                 default_rps: Mapping[str, float],
                 features: Mapping[str, Sequence[str]]) -> Dict[str, float]:
        """models: sid -> tp_max PolynomialModel (RASK's learned surface).

        The environment model: action -> clipped params -> tp_max = w(p) ->
        reward = weighted SLO fulfillment at the service's *default* RPS
        (the paper notes the DQN "was not trained for different RPS").
        """
        losses = {}
        dev = self.device
        for sid, net in self.nets.items():
            model = models[sid]
            rps = float(default_rps[sid])
            feat_idx = [net.names.index(f) for f in features[sid]]
            buf_s, buf_a, buf_r, buf_s2, buf_d = [], [], [], [], []
            p = (net.lo + net.hi) / 2.0
            completion = 0.0
            eps = self.cfg.eps_start
            last_loss = float("nan")
            for step in range(self.cfg.train_steps):
                if step % self.cfg.episode_len == 0:
                    p = self.rng.uniform(net.lo, net.hi).astype(np.float32)
                s = net.norm_state(p, rps, completion)
                if self.rng.random() < eps:
                    a = int(self.rng.integers(net.n_actions))
                else:
                    a = int(np.argmax(net.q_values(s)))
                p2 = net.apply_action(p, a)
                tp = float(model.predict(p2[feat_idx]))
                r = net.reward(p2, tp, rps)
                completion2 = min(tp / max(rps, 1e-9), 1.0)
                s2 = net.norm_state(p2, rps, completion2)
                buf_s.append(s); buf_a.append(a); buf_r.append(r)
                buf_s2.append(s2); buf_d.append(0.0)
                if len(buf_s) > self.cfg.buffer:
                    del buf_s[0], buf_a[0], buf_r[0], buf_s2[0], buf_d[0]
                p, completion = p2, completion2
                eps = max(self.cfg.eps_end,
                          eps - (self.cfg.eps_start - self.cfg.eps_end)
                          / (0.8 * self.cfg.train_steps))
                if len(buf_s) >= self.cfg.batch_size:
                    idx = self.rng.integers(len(buf_s), size=self.cfg.batch_size)
                    loss = net.td_step(
                        upload(np.stack([buf_s[i] for i in idx]), dev),
                        upload(np.asarray([buf_a[i] for i in idx], np.int64),
                               dev),
                        upload(np.asarray([buf_r[i] for i in idx],
                                          np.float32), dev),
                        upload(np.stack([buf_s2[i] for i in idx]), dev),
                        upload(np.asarray([buf_d[i] for i in idx],
                                          np.float32), dev),
                        self.cfg.lr)
                    last_loss = float(loss)
                if step % self.cfg.target_sync == 0:
                    net.sync_target()
            losses[sid] = last_loss
        return losses

    # -- online: one greedy action per service per cycle -------------------------
    def observe(self, t: float, window: float = 5.0
                ) -> Dict[str, Dict[str, float]]:
        """Stabilized state + current assignment per service (bulk query)."""
        windowed = self.platform.window_states(since=t - window, until=t)
        obs = {}
        for sid in self.nets:
            row = dict(windowed.get(sid) or {})
            row.update(self.platform.assignment(sid))
            obs[sid] = row
        return obs

    def decide(self, obs: Mapping[str, Mapping[str, float]]) -> ScalingPlan:
        self.rounds += 1
        self.last_decision = DecisionInfo()
        plan = ScalingPlan(agent=self.name, cycle=self.rounds)
        for sid, net in self.nets.items():
            row = obs.get(sid, {})
            p = np.asarray([row[n] for n in net.names], np.float32)
            rps = float(row.get("rps", 0.0))
            comp = float(row.get("completion", 0.0))
            s = net.norm_state(p, rps, comp)
            a = int(np.argmax(net.q_values(s)))
            p2 = net.apply_action(p, a)
            for n, v in zip(net.names, p2):
                plan.set(sid, n, float(v))
        return plan
