"""The port's ridge fit (src/repro_torch/core/regression.py) against the JAX
package's, on the same numpy data.

* Batched fit (``fit_batched_arrays`` through ``BatchedFitPlan.fit``):
  predictions within 1e-4 of the span. Raw weights are not compared: the
  normal equations are ill-conditioned, so an LU solve in another order
  moves them (``tests/test_rask.py`` compares them only loosely for the
  same reason).
* Streaming engine: the Gram system and ``xty`` after interleaved pushes
  with evictions, and after the exact resync, within 1e-5 of the span (the
  gate of ``tests/test_streaming_fit.py``), and the streaming fit's
  predictions within 1e-4.
"""
import numpy as np
import pytest
import torch

from repro.core.regression import BatchedFitPlan as JPlan
from repro_torch.core.regression import TRACE_COUNTS, BatchedFitPlan, \
    polynomial_exponents

torch.set_num_threads(1)


def _relations(rng, n_rel):
    rels = []
    for _ in range(n_rel):
        f = int(rng.integers(1, 4))
        rels.append(dict(n_features=f, degree=int(rng.integers(1, 4)),
                         x_scale=rng.uniform(0.5, 8.0, f).tolist(),
                         target="tp_max"))
    return rels


def _rows(rng, f, n):
    X = rng.uniform(0.1, 8.0, (n, f)).astype(np.float32)
    coef = rng.uniform(-2, 2, f)
    Y = ((X * coef).sum(axis=1) ** 2 + rng.normal(0, 0.1, n)).astype(
        np.float32)
    return X, Y


def _rel(a, b, span):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))) / span


def test_polynomial_exponents_are_repros():
    from repro.core.regression import polynomial_exponents as jexp
    for f in range(1, 4):
        for d in range(0, 5):
            np.testing.assert_array_equal(polynomial_exponents(f, d),
                                          jexp(f, d))


@pytest.mark.parametrize("seed,ridge", [(0, 1e-6), (1, 1e-6), (2, 1e-4),
                                        (3, 1e-4), (4, 1e-6)])
def test_batched_fit_predictions_match_jax(seed, ridge):
    rng = np.random.default_rng(seed * 613)
    rels = _relations(rng, int(rng.integers(1, 6)))
    data = [_rows(rng, r["n_features"], int(rng.integers(5, 60)))
            for r in rels]
    cap = 64
    want = JPlan(rels, row_capacity=cap, ridge=ridge).fit(data)
    got = BatchedFitPlan(rels, row_capacity=cap, ridge=ridge).fit(data)
    for i, (X, Y) in enumerate(data):
        w = np.asarray(want.model(i).predict(X))
        g = got.model(i).predict(X).numpy()
        span = max(float(np.abs(w).max()), 1.0)
        assert _rel(g, w, span) <= 1e-4, i


def _push_both(rng, rels, cap, n_total):
    """Interleaved random-size pushes (some empty) into both packages'
    streaming states; returns both plans and states and the row history."""
    jp = JPlan(rels, row_capacity=cap, ridge=1e-4)
    tp = BatchedFitPlan(rels, row_capacity=cap, ridge=1e-4)
    js, ts = jp.stream_init(), tp.stream_init()
    hist = [_rows(rng, r["n_features"], n_total) for r in rels]
    done = [0] * len(rels)
    while min(done) < n_total:
        deltas = []
        for i in range(len(rels)):
            k = min(int(rng.integers(0, 4)), n_total - done[i])
            X, Y = hist[i]
            deltas.append((X[done[i]:done[i] + k], Y[done[i]:done[i] + k]))
            done[i] += k
        js = jp.stream_push(js, deltas)
        ts = tp.stream_push(ts, deltas)
    return jp, js, tp, ts, hist


@pytest.mark.parametrize("seed,n_total", [(s, 5 + (s * 11) % 40)
                                          for s in range(6)])
def test_stream_gram_matches_jax_through_evictions_and_resync(seed,
                                                              n_total):
    rng = np.random.default_rng(seed * 7919)
    rels = _relations(rng, int(rng.integers(1, 5)))
    jp, js, tp, ts, _ = _push_both(rng, rels, 16, n_total)
    assert ts.count.tolist() == np.asarray(js.count).tolist()
    span = max(float(np.abs(np.asarray(js.gram)).max()),
               float(np.abs(np.asarray(js.xty)).max()), 1.0)
    assert _rel(ts.gram, js.gram, span) <= 1e-5
    assert _rel(ts.xty, js.xty, span) <= 1e-5
    # the ring (without its scratch row) holds the same rows
    np.testing.assert_allclose(ts.phi[:, :16].numpy(), np.asarray(js.phi),
                               rtol=1e-5, atol=1e-5)
    jr, tr = jp.stream_resync(js), tp.stream_resync_arrays(ts)
    assert _rel(tr.gram, jr.gram, span) <= 1e-5
    assert _rel(tr.xty, jr.xty, span) <= 1e-5
    assert _rel(tr.gram, ts.gram, span) <= 1e-5     # drift stays bounded


@pytest.mark.parametrize("seed", range(3))
def test_stream_fit_predictions_match_jax(seed):
    rng = np.random.default_rng(seed * 104729)
    rels = _relations(rng, int(rng.integers(1, 4)))
    jp, js, tp, ts, hist = _push_both(rng, rels, 16,
                                      int(rng.integers(20, 60)))
    want, got = jp.stream_fit(js), tp.stream_fit(ts)
    for i, (X, _) in enumerate(hist):
        w = np.asarray(want.model(i).predict(X[-16:]))
        g = got.model(i).predict(X[-16:]).numpy()
        assert _rel(g, w, max(float(np.abs(w).max()), 1.0)) <= 1e-4, i


def test_rebuild_counts_one_design_upload_and_pushes_count_rows():
    rng = np.random.default_rng(3)
    rels = _relations(rng, 3)
    plan = BatchedFitPlan(rels, row_capacity=16)
    data = [_rows(rng, r["n_features"], 10) for r in rels]
    before = dict(TRACE_COUNTS)
    state = plan.stream_rebuild(data)
    assert TRACE_COUNTS["h2d_design_upload"] == \
        before.get("h2d_design_upload", 0) + 1
    plan.stream_push(state, [_rows(rng, r["n_features"], 1) for r in rels])
    assert TRACE_COUNTS["h2d_delta_rows"] == \
        before.get("h2d_delta_rows", 0) + 30 + 3
    assert TRACE_COUNTS["h2d_design_upload"] == \
        before.get("h2d_design_upload", 0) + 1
