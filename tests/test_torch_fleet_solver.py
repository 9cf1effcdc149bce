"""The port's bucketed fleet solve and batched placement scoring
(src/repro_torch/core/solver.py) against ``repro``'s, on the CPU.

* Layout bucketing — ``bucket_key``, singleton merging and the ``auto``
  collapse — gives ``repro``'s buckets on the layouts of
  ``tests/test_bucketed_solver.py`` (one parametrised case each).
* Every ``FleetBucket`` table, gather map and gathered model equals
  ``repro``'s exactly (integer maps and float32 copies, no arithmetic).
* ``FleetSolverProblem.solve_many`` and ``PlacementProblem.scores`` are fed
  the uniforms ``repro`` draws for each row (``jax.random.split`` of the
  solve key, indexed by the row's fleet or candidate index) and give each
  row's score within 1e-3 relative of ``repro``'s, as
  ``tests/test_torch_solver.py`` holds one host (``repro`` differentiates
  with ``jax.grad``, the port with the analytic VJP, over 32 Adam steps);
  every plan is feasible per host. The batched solve equals the port's own
  per-row loop (``solve_sequential``, ``scores_sequential``) within 1e-5.
  The fleet's bucket order differs from its host order.
* The batched plain objective and its VJP equal ``jax.vmap`` of ``repro``'s
  Pallas kernel in interpret mode (and of ``repro``'s VJP) within 1e-4
  over a bucket's padded rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solver as jsolver
from repro.core.regression import BatchedFitPlan as JPlan
from repro.core.slo import SLO as JSLO
from repro.env import paper_knowledge, paper_profiles
from repro.kernels import ops as jops
from repro.kernels.rask_objective import rask_objective_grad as jgrad
from repro_torch.core import solver as tsolver
from repro_torch.core.regression import StackedModels
from repro_torch.core.slo import SLO
from repro_torch.kernels import ref

torch.set_num_threads(1)
REL = 1e-3          # a row's score against repro's (test_torch_solver.py)


def _specs(module, slo_cls, names):
    """Paper services (QR/CV/PC, in turn) named ``names``."""
    profs = list(paper_profiles().values())
    specs = []
    for i, name in enumerate(names):
        p = profs[i % 3]
        pn = tuple(p.api.names)
        specs.append(module.ServiceSpec(
            name=name, param_names=pn,
            lower=tuple(x.min_value for x in p.api.parameters),
            upper=tuple(x.max_value for x in p.api.parameters),
            resource_mask=tuple(x.name == "cores" for x in p.api.parameters),
            slos=tuple(slo_cls(q.metric, q.target, q.weight)
                       for q in p.slos),
            relation_features=tuple(
                (t, tuple(pn.index(f) for f in fs))
                for t, fs in paper_knowledge()[p.type].items())))
    return specs


def _fleet(counts, hosts=None, cap_per_service=2.5):
    """Both packages' problems for a fleet of ``counts[h]`` services on
    host ``hosts[h]``, models fitted by ``repro`` (degree 2) to each
    service's hidden throughput surface, and a load vector."""
    hosts = hosts or [f"h{h}" for h in range(len(counts))]
    names, host_of = [], {}
    for h, c in zip(hosts, counts):
        for j in range(c):
            names.append(f"{h}/s{j}")
            host_of[names[-1]] = h
    caps = {h: cap_per_service * c for h, c in zip(hosts, counts)}
    jp = jsolver.SolverProblem(_specs(jsolver, JSLO, names))
    tp = tsolver.SolverProblem(_specs(tsolver, SLO, names))
    rng = np.random.default_rng(len(names))
    profs = list(paper_profiles().values())
    rels, data = [], []
    for i, spec in enumerate(jp.specs):
        for _, feat in spec.relation_features:
            X = rng.uniform(spec.lower, spec.upper,
                            (24, len(spec.lower))).astype(np.float32)
            Y = np.asarray([profs[i % 3].tp_max(dict(zip(spec.param_names,
                                                          x))) for x in X],
                           np.float32)
            rels.append(dict(n_features=len(feat), degree=2,
                             x_scale=[spec.upper[j] for j in feat]))
            data.append((X[:, list(feat)], Y))
    jsm = JPlan(rels, row_capacity=32).fit(data)
    tsm = StackedModels(*(torch.from_numpy(np.array(x)) for x in (
        jsm.w, jsm.exponents, jsm.term_mask, jsm.x_scale)), jsm.max_degree)
    rps = rng.uniform(5, 60, len(names)).astype(np.float32)
    return jp, tp, host_of, caps, jsm, tsm, rps


def _repro_uniforms(buckets, key, n_rows, n_starts):
    """``repro``'s per-row draws: row k of the batch (fleet host or
    candidate index) takes ``uniform(split(key, n_rows)[k], (n_starts - 3,
    D_max))`` for its bucket's D_max."""
    keys = jax.random.split(key, max(n_rows, 1))
    return [np.stack([np.asarray(jax.random.uniform(
        keys[int(k)], (n_starts - 3, bk.arrays["lower"].shape[1])))
        for k in bk.host_idx]) for bk in buckets]


# -- layout bucketing -----------------------------------------------------

def test_layout_bucket_and_key_are_repros():
    for n in range(0, 300):
        assert tsolver.layout_bucket(n) == jsolver.layout_bucket(n)
        assert tsolver.bucket_key(n, 2 * n + 1) == \
            jsolver.bucket_key(n, 2 * n + 1)


@pytest.mark.parametrize("counts", [[8, 1, 1], [2, 2, 3, 3], [2] * 12 + [8, 8],
                                    [3, 3, 3], [1], [5, 2, 9, 1, 3],
                                    [1, 1, 1, 16, 16]])
@pytest.mark.parametrize("bucketed", [True, False, "auto"])
def test_buckets_are_repros(counts, bucketed):
    """Bucket keys, singleton merging and the auto collapse (the cases of
    tests/test_bucketed_solver.py) give ``repro``'s buckets."""
    jp, tp, host_of, caps, *_ = _fleet(counts)
    jf = jsolver.FleetSolverProblem(jp, host_of, caps, bucketed=bucketed)
    tf = tsolver.FleetSolverProblem(tp, host_of, caps, bucketed=bucketed)
    assert tf.hosts == jf.hosts and tf.bucket_of == jf.bucket_of
    assert [bk.hosts for bk in tf.buckets] == [bk.hosts for bk in jf.buckets]
    assert [bk.key for bk in tf.buckets] == [bk.key for bk in jf.buckets]
    assert tf.layout_key == jf.layout_key      # both lead with ("shards", 1)


def _assert_bucket_equal(tb, jb, jsm, tsm):
    jt = jb.tables
    for name in jsolver.ProblemTables._fields:
        np.testing.assert_array_equal(getattr(tb.tables, name).numpy(),
                                      np.asarray(getattr(jt, name)))
    for name in ("param_take", "rel_take", "rel_valid", "svc_take", "loc_b",
                 "loc_d", "caps"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    np.testing.assert_array_equal(tb.g_idx, jb.g_idx)
    np.testing.assert_array_equal(tb.host_idx, jb.host_idx)
    assert (tb.hosts, tb.key, tb.dim, tb.n_services_max) == \
        (jb.hosts, jb.key, jb.dim, jb.n_services_max)
    tg, jg = tb.gather_models(tsm), jb.gather_models(jsm)
    for name in ("w", "exponents", "term_mask", "x_scale"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)))


def test_fleet_and_placement_bucket_tables_are_repros():
    jp, tp, host_of, caps, jsm, tsm, _ = _fleet([2, 6, 1, 9, 3])
    for bucketed in (True, False, "auto"):
        jf = jsolver.FleetSolverProblem(jp, host_of, caps, bucketed=bucketed)
        tf = tsolver.FleetSolverProblem(tp, host_of, caps, bucketed=bucketed)
        for tb, jb in zip(tf.buckets, jf.buckets, strict=True):
            _assert_bucket_equal(tb, jb, jsm, tsm)
    subsets = [(0, 1), (), (2, 3, 4, 5), (0, 2, 4, 6, 8, 10, 12), (7,),
               (1, 7, 14, 20), (3, 4)]
    capacities = [5.0, 4.0, 12.0, 18.0, 2.0, 9.0, 6.0]
    jpp = jsolver.PlacementProblem(jp, subsets, capacities)
    tpp = tsolver.PlacementProblem(tp, subsets, capacities)
    np.testing.assert_array_equal(tpp._order, jpp._order)
    for tb, jb in zip(tpp.buckets, jpp.buckets, strict=True):
        _assert_bucket_equal(tb, jb, jsm, tsm)


# -- the fleet solve ------------------------------------------------------------

def _feasible(problem, a, host_of, caps):
    assert np.all(a >= problem.lower - 1e-5)
    assert np.all(a <= problem.upper + 1e-5)
    used = {h: 0.0 for h in caps}
    for i, s in enumerate(problem.specs):
        used[host_of[s.name]] += float(a[problem.offsets[i]])
    for h, c in caps.items():
        assert used[h] <= c, (h, used[h], c)


# gateways first by name, so the bucket order (small layouts first) is not
# the host order; [1, 1, 1, 16, 16] keeps two buckets under "auto"
HETERO = dict(counts=[16, 16, 1, 1, 1], hosts=["a-gw", "b-gw", "c-cam",
                                               "d-cam", "e-cam"])


@pytest.mark.parametrize("case", [HETERO, dict(counts=[3, 3, 4, 2])],
                         ids=["two_buckets", "one_bucket"])
@pytest.mark.parametrize("seed", [0, 1])
def test_solve_many_matches_repro_and_its_per_row_loop(case, seed):
    jp, tp, host_of, caps, jsm, tsm, rps = _fleet(**case)
    jf = jsolver.FleetSolverProblem(jp, host_of, caps)
    tf = tsolver.FleetSolverProblem(tp, host_of, caps)
    if case is HETERO:
        assert len(tf.buckets) == 2
        order = [h for bk in tf.buckets for h in bk.hosts]
        assert order != list(tf.hosts)
    x0 = jf.random_assignment(np.random.default_rng(seed))
    a_j, s_j = jf.solve_many(jsm, rps, x0, seed=seed)
    u = _repro_uniforms(tf.buckets, jax.random.PRNGKey(seed),
                        len(tf.hosts), 6)
    a_t, s_t = tf.solve_many(tsm, rps, x0, u=u)
    assert s_t.shape == s_j.shape == (len(tf.hosts),)
    np.testing.assert_array_less(np.abs(s_t - s_j), REL * np.abs(s_j) + 1e-6)
    for a in (np.asarray(a_j), a_t):
        _feasible(jp, a, host_of, caps)
    a_q, s_q = tf.solve_sequential(tsm, rps, x0, u=u)
    np.testing.assert_allclose(s_q, s_t, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a_q, a_t, rtol=1e-5, atol=1e-5)


def test_fleet_random_assignment_is_repros():
    jp, tp, host_of, caps, *_ = _fleet(**HETERO)
    jf = jsolver.FleetSolverProblem(jp, host_of, caps)
    tf = tsolver.FleetSolverProblem(tp, host_of, caps)
    for seed in range(4):
        want = jf.random_assignment(np.random.default_rng(seed))
        got = tf.random_assignment(np.random.default_rng(seed))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        _feasible(jp, got, host_of, caps)


# -- placement scoring -----------------------------------------------------------

@pytest.mark.parametrize("bucketed", [True, "auto"])
def test_placement_scores_match_repro_and_its_per_row_loop(bucketed):
    """Overlapping candidates (the with/without subsets of a placement
    snapshot), an empty one among them."""
    jp, tp, host_of, caps, jsm, tsm, rps = _fleet([3, 5, 2])
    hosts = sorted(caps)
    res = {h: tuple(i for i, s in enumerate(jp.specs)
                    if host_of[s.name] == h) for h in hosts}
    subsets, capacities = [()], [1.0]
    for h in hosts:
        subsets.append(res[h])
        capacities.append(caps[h])
        for i in range(len(jp.specs)):
            sub = tuple(j for j in res[h] if j != i) if i in res[h] \
                else tuple(sorted(res[h] + (i,)))
            subsets.append(sub)
            capacities.append(caps[h])
    jpp = jsolver.PlacementProblem(jp, subsets, capacities, bucketed=bucketed)
    tpp = tsolver.PlacementProblem(tp, subsets, capacities, bucketed=bucketed)
    x0 = (0.5 * (jp.lower + jp.upper)).astype(np.float32)
    want = jpp.scores(jsm, rps, x0, n_starts=4, iters=16, seed=0)
    u = _repro_uniforms(tpp.buckets, jax.random.PRNGKey(0), len(subsets), 4)
    got = tpp.scores(tsm, rps, x0, n_starts=4, iters=16, u=u)
    assert got[0] == want[0] == 0.0
    np.testing.assert_array_less(np.abs(got - want),
                                 REL * np.abs(want) + 1e-6)
    seq = tpp.scores_sequential(tsm, rps, x0, n_starts=4, iters=16, u=u)
    np.testing.assert_allclose(seq, got, rtol=1e-5, atol=1e-5)


def test_all_empty_candidates_score_zero_without_a_solve():
    jp, tp, _, _, _, tsm, rps = _fleet([2])
    tpp = tsolver.PlacementProblem(tp, [(), ()], [3.0, 4.0])
    assert tpp.buckets == []
    x0 = (0.5 * (jp.lower + jp.upper)).astype(np.float32)
    np.testing.assert_array_equal(tpp.scores(tsm, rps, x0), [0.0, 0.0])
    np.testing.assert_array_equal(tpp.scores_sequential(tsm, rps, x0),
                                  [0.0, 0.0])


# -- the batched plain objective against repro's vmapped Pallas kernel ----------

def test_batched_plain_objective_and_vjp_match_vmapped_pallas_interpret():
    jp, tp, host_of, caps, jsm, tsm, rps = _fleet(**HETERO)
    tf = tsolver.FleetSolverProblem(tp, host_of, caps)
    rng = np.random.default_rng(3)
    for bk in tf.buckets:
        t = bk.tables
        sm = bk.gather_models(tsm)
        B, D = t.lower.shape
        K, S = 6, bk.n_services_max
        A = (t.lower[:, None] + torch.from_numpy(rng.random(
            (B, K, D)).astype(np.float32)) * (t.upper - t.lower)[:, None])
        ct = torch.from_numpy(rng.standard_normal((B, K, S))
                              .astype(np.float32))
        rpsb = torch.from_numpy(rps)[bk.svc_take]
        args = (A, t.rel_gather, sm.w, sm.exponents, sm.term_mask,
                sm.x_scale, t.slo_kind, t.slo_service, t.slo_weight,
                t.slo_target, t.slo_pidx, t.slo_ridx, rpsb)
        kw = dict(n_services=S, max_degree=sm.max_degree)
        got = ref.rask_objective_reference(*args, **kw).numpy()
        got_dA = ref.rask_objective_grad(A, ct, *args[1:], **kw).numpy()
        jargs = [jnp.asarray(x.numpy()) for x in args]

        def pallas(*a):
            return jops.rask_objective(*a, **kw, impl="pallas_interpret")

        want = np.asarray(jax.vmap(pallas)(*jargs))
        _, vjp = jax.vjp(lambda a0: jax.vmap(pallas)(a0, *jargs[1:]),
                         jargs[0])
        want_dA = np.asarray(vjp(jnp.asarray(ct.numpy()))[0])
        want_grad = np.asarray(jax.vmap(
            lambda a0, c, *tb: jgrad(a0, c, *tb, **kw))(
                jargs[0], jnp.asarray(ct.numpy()), *jargs[1:]))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got_dA, want_dA, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got_dA, want_grad, atol=1e-4, rtol=1e-4)
        # padded services read nothing, padded parameters get no gradient
        for b in range(B):
            d = int(bk.arrays["upper"][b].astype(bool).sum())
            assert not got_dA[b, :, d:].any() or d == D
