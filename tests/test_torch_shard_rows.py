"""The port's ``shard_rows`` (``src/repro_torch/core/solver.py``): a layout
bucket's rows spread over devices, the counterpart of ``repro``'s sharded
solver tests (``tests/test_fleet_solver.py``), on the CPU.

``repro`` runs those tests on 8 forced host devices; the port takes an
explicit device list, here N entries of the CPU, so every chunk of rows
runs its own batched solve as it would on its own card.

* ``shard_rows`` cuts B rows into contiguous chunks of ceil(B / n) and
  drops the empty ones, for rows in {1, 2, 3, 5, 8} x shards in {1, 2, 3,
  8}; the fleet solve over those chunks equals the unsharded one byte for
  byte.
* The sharded fleet solve and the sharded placement scores are
  byte-identical to the unsharded ones over random layouts (hypothesis, 5
  examples each, as ``repro``'s).
* Both are held to ``repro``'s unsharded solve from the same uniforms at
  ``tests/test_torch_fleet_solver.py``'s tolerance (a row's score within
  1e-3 relative).
* ``layout_key`` leads with the shard count, as ``repro``'s does, and
  ``RaskConfig.shard`` reaches the fleet and the placement problems.
* Each chunk's solve runs with its device current
  (``device.device_guard``), and with a second card current a kernel's
  device check takes tensors on that card (a fake card: the CPU has
  none).
"""
import contextlib

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import solver as jsolver
from repro_torch.core import RASKAgent, RaskConfig
from repro_torch.core import solver as tsolver
from repro_torch.device import device_guard
from repro_torch.kernels import _build
from repro_torch.env import EdgeEnvironment, paper_knowledge, paper_profiles
from test_torch_fleet_solver import REL, _fleet, _repro_uniforms

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _cpus(n):
    return [CPU] * n


@pytest.mark.parametrize("shards", [1, 2, 3, 8])
@pytest.mark.parametrize("rows", [1, 2, 3, 5, 8])
def test_shard_rows_byte_identical_over_any_layout(rows, shards):
    """The chunks cover the rows in order, ceil(B / n) at most each, none
    empty; one bucket of ``rows`` hosts solved over them equals the
    unsharded solve byte for byte."""
    chunks = tsolver.shard_rows(rows, _cpus(shards))
    per = -(-rows // shards)
    assert [r for _, sl in chunks for r in range(rows)[sl]] == \
        list(range(rows))
    assert all(0 < sl.stop - sl.start <= per for _, sl in chunks)
    assert len(chunks) == min(shards, -(-rows // per))
    jp, tp, host_of, caps, _, tsm, rps = _fleet([3] * rows)
    one = tsolver.FleetSolverProblem(tp, host_of, caps, shard=False)
    many = tsolver.FleetSolverProblem(tp, host_of, caps,
                                      devices=_cpus(shards))
    assert len(one.buckets) == len(many.buckets) == 1
    assert [sl for _, sl, *_ in many.buckets[0].shards] == \
        [sl for _, sl in chunks]
    x0 = one.random_assignment(np.random.default_rng(rows))
    kw = dict(n_starts=4, iters=8, seed=rows)
    a_1, s_1 = one.solve_many(tsm, rps, x0, **kw)
    a_n, s_n = many.solve_many(tsm, rps, x0, **kw)
    assert np.array_equal(a_n, a_1) and np.array_equal(s_n, s_1)


@settings(max_examples=5, deadline=None)
@given(st.integers(4, 10), st.integers(2, 4), st.integers(2, 8),
       st.integers(0, 2 ** 16))
def test_sharded_fleet_solve_byte_identical_to_unsharded(n, n_hosts, shards,
                                                         seed):
    """Random services on random hosts: ``shards`` devices reproduce the
    one-device solve byte for byte."""
    rng = np.random.default_rng(seed)
    counts = [int(c) for c in np.bincount(rng.integers(n_hosts, size=n))
              if c]
    _, tp, host_of, caps, _, tsm, rps = _fleet(counts)
    fp_n = tsolver.FleetSolverProblem(tp, host_of, caps,
                                      devices=_cpus(shards))
    fp_0 = tsolver.FleetSolverProblem(tp, host_of, caps, shard=False)
    x0 = fp_0.random_assignment(np.random.default_rng(seed + 1))
    kw = dict(n_starts=4, iters=4, seed=seed % 97)
    a_n, s_n = fp_n.solve_many(tsm, rps, x0, **kw)
    a_0, s_0 = fp_0.solve_many(tsm, rps, x0, **kw)
    assert np.array_equal(a_n, a_0)
    assert np.array_equal(s_n, s_0)


def _subsets(n, rng):
    subsets = [sorted(rng.choice(n, size=int(rng.integers(1, 4)),
                                 replace=False).tolist())
               for _ in range(int(rng.integers(3, 8)))] + [[]]
    return subsets, [float(rng.uniform(2.0, 10.0)) for _ in subsets]


@settings(max_examples=5, deadline=None)
@given(st.integers(5, 10), st.integers(2, 8), st.integers(0, 2 ** 16))
def test_sharded_placement_scores_byte_identical(n, shards, seed):
    """Overlapping candidate subsets, an empty one among them, score
    byte-identically sharded and unsharded."""
    _, tp, _, _, _, tsm, rps = _fleet([n])
    subsets, caps = _subsets(n, np.random.default_rng(seed))
    pp_n = tsolver.PlacementProblem(tp, subsets, caps, devices=_cpus(shards))
    pp_0 = tsolver.PlacementProblem(tp, subsets, caps, shard=False)
    x0 = (0.5 * (tp.lower + tp.upper)).astype(np.float32)
    kw = dict(n_starts=4, iters=4, seed=seed % 89)
    assert np.array_equal(pp_n.scores(tsm, rps, x0, **kw),
                          pp_0.scores(tsm, rps, x0, **kw))


@pytest.fixture(scope="module")
def hetero():
    """Two buckets (16-service gateways, 1-service cameras) and
    ``repro``'s unsharded solve of them, with its draws."""
    kw = dict(counts=[16, 16, 1, 1, 1],
              hosts=["a-gw", "b-gw", "c-cam", "d-cam", "e-cam"])
    jp, tp, host_of, caps, jsm, tsm, rps = _fleet(**kw)
    jf = jsolver.FleetSolverProblem(jp, host_of, caps, shard=False)
    x0 = jf.random_assignment(np.random.default_rng(0))
    a_j, s_j = jf.solve_many(jsm, rps, x0, seed=0)
    return tp, host_of, caps, tsm, rps, x0, np.asarray(a_j), s_j


@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_fleet_solve_matches_repro(hetero, shards):
    """Every row's score against ``repro``'s unsharded solve from
    ``repro``'s draws."""
    tp, host_of, caps, tsm, rps, x0, a_j, s_j = hetero
    tf = tsolver.FleetSolverProblem(tp, host_of, caps, devices=_cpus(shards))
    assert len(tf.buckets) == 2
    u = _repro_uniforms(tf.buckets, jax.random.PRNGKey(0), len(tf.hosts), 6)
    a_t, s_t = tf.solve_many(tsm, rps, x0, u=u)
    np.testing.assert_array_less(np.abs(s_t - s_j), REL * np.abs(s_j) + 1e-6)
    assert a_t.shape == a_j.shape


def test_sharded_placement_scores_match_repro():
    jp, tp, _, _, jsm, tsm, rps = _fleet([7])
    subsets, caps = _subsets(7, np.random.default_rng(5))
    jpp = jsolver.PlacementProblem(jp, subsets, caps, shard=False)
    tpp = tsolver.PlacementProblem(tp, subsets, caps, devices=_cpus(3))
    x0 = (0.5 * (jp.lower + jp.upper)).astype(np.float32)
    want = jpp.scores(jsm, rps, x0, n_starts=4, iters=16, seed=0)
    u = _repro_uniforms(tpp.buckets, jax.random.PRNGKey(0), len(subsets), 4)
    got = tpp.scores(tsm, rps, x0, n_starts=4, iters=16, u=u)
    assert got[-1] == want[-1] == 0.0
    np.testing.assert_array_less(np.abs(got - want),
                                 REL * np.abs(want) + 1e-6)


def test_shard_count_re_keys_layout_key():
    """The resolved shard count leads ``layout_key``, as in ``repro``; on
    one device the port's key is ``repro``'s."""
    jp, tp, host_of, caps, *_ = _fleet([2, 2])
    fp_a = tsolver.FleetSolverProblem(tp, host_of, caps, shard="auto")
    fp_0 = tsolver.FleetSolverProblem(tp, host_of, caps, shard=False)
    fp_4 = tsolver.FleetSolverProblem(tp, host_of, caps, shard=4)
    assert fp_a.n_shards == fp_0.n_shards == 1 and fp_4.n_shards == 4
    assert fp_a.layout_key == fp_0.layout_key != fp_4.layout_key
    assert fp_4.layout_key[0] == ("shards", 4)
    jf = jsolver.FleetSolverProblem(jp, host_of, caps, shard="auto")
    assert fp_a.layout_key == jf.layout_key


@pytest.mark.parametrize("shard", ["auto", False, 3])
def test_rask_config_shard_reaches_both_problems(shard):
    assert RaskConfig().shard == "auto"
    profs = list(paper_profiles().values())
    env = EdgeEnvironment(profs, {"cores": 8.0}, replicas=2, hosts=2)
    agent = RASKAgent(env.platform, paper_knowledge(),
                      RaskConfig(xi=2, shard=shard), device="cpu")
    want = 3 if shard == 3 else 1
    assert agent.fleet_problem.n_shards == want
    residents = {}
    for sid in agent.services:
        residents.setdefault(env.platform.host_of(sid).host, []).append(
            [s.name for s in agent.problem.specs].index(sid))
    pp, _ = agent._placement_problem(
        {h: tuple(sorted(v)) for h, v in residents.items()},
        {h.host: h.capacity["cores"] for h in env.platform.hosts()})
    assert pp.n_shards == want
    assert all(len(bk.shards) == min(want, len(bk.hosts))
               for bk in agent.fleet_problem.buckets)


def test_each_chunk_solves_with_its_device_current(monkeypatch):
    """Every chunk's ``pgd_solve`` runs inside the guard of the device its
    inputs were sent to, one guard a chunk, in row order."""
    active, guarded, solves = [], [], []

    @contextlib.contextmanager
    def guard(where):
        guarded.append(where)
        active.append(len(guarded) - 1)
        yield
        active.pop()

    real = tsolver.pgd_solve

    def solve(x0, *args, **kw):
        solves.append((list(active), x0.device, x0.shape[0]))
        return real(x0, *args, **kw)
    monkeypatch.setattr(tsolver, "device_guard", guard)
    monkeypatch.setattr(tsolver, "pgd_solve", solve)
    _, tp, host_of, caps, _, tsm, rps = _fleet([3] * 5)
    fp = tsolver.FleetSolverProblem(tp, host_of, caps, devices=_cpus(3))
    chunks = fp.buckets[0].shards
    fp.solve_many(tsm, rps, fp.random_assignment(np.random.default_rng(0)),
                  n_starts=4, iters=2)
    assert guarded == [where for where, *_ in chunks]
    assert [(a, n) for a, _, n in solves] == [
        ([i], sl.stop - sl.start) for i, (_, sl, *_) in enumerate(chunks)]


class _OnCard:
    """What a kernel's device check reads of a tensor on a card."""

    def __init__(self, index):
        self.device = torch.device("cuda", index)

    def is_contiguous(self):
        return True


def test_device_guard_makes_a_second_card_current(monkeypatch):
    """A kernel checks that its tensors are on the current card
    (``_build.require_cuda``): a chunk's tensors on cuda:1 fail it while
    cuda:0 is current and pass it inside ``device_guard(cuda:1)``, which
    puts cuda:0 back on leaving. The CPU guard does nothing."""
    current = [0]

    class FakeDevice:
        def __init__(self, device):
            self.idx = torch.device(device).index

        def __enter__(self):
            self.prev, current[0] = current[0], self.idx

        def __exit__(self, *exc):
            current[0] = self.prev
    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    t = _OnCard(1)
    with pytest.raises(ValueError, match="current device is cuda:0"):
        _build.require_cuda("rask_objective_forward", t)
    with device_guard(torch.device("cuda", 1)):
        assert _build.require_cuda("rask_objective_forward", t) == \
            torch.device("cuda", 1)
    assert current == [0]
    with device_guard(CPU):
        assert current == [0]
