"""The port's load forecaster (src/repro_torch/core/forecast.py) and the
lagged-window export it reads (``core/telemetry.py``) against ``repro``'s,
on the same seeded numpy data, on the CPU.

* ``lagged_windows`` and ``lag_tail``: equal to ``repro``'s, exactly, with
  NaN gaps, delta cursors and retention compaction.
* ``LoadForecaster``: the streaming (rebuild, then a rank-k delta push)
  and the batch fit, at the bars of ``tests/test_torch_regression.py``:
  the Gram system within 1e-5 of its span, and the fit judged by its
  predictions (on the training windows and on the current lag windows)
  within 1e-4 of the span — the AR normal equations over strongly
  correlated lags are ill-conditioned, so raw weights are compared only
  through what they predict; ``rps_eff`` (the blend the solve sees) at the
  same bar.
* the hybrid gate (``settle``, ``use_mask``, ``inject_error``) and the
  transfer priors (``prior_arrays``, ``type_means``): equal, exactly for
  the host-side bookkeeping.
* the GRU: ``gru_predict`` on ``repro``'s parameters within 1e-5, and
  ``fit_gru`` from ``repro``'s initial parameters with losses within 1e-4
  relative over 60 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import forecast as jfc
from repro.core.regression import fit_batched_arrays
from repro.core.telemetry import TrainingTable as JTable
from repro_torch.core import forecast as tfc
from repro_torch.core.telemetry import TrainingTable

torch.set_num_threads(1)
SERVICES = ("edge-0/qr-detector/c0", "edge-0/cv-analyzer/c0",
            "edge-0/pc-visualizer/c0")
TYPES = ("qr-detector", "cv-analyzer", "pc-visualizer")


def _rps(rng, n, base):
    """A noisy AR-ish load series with NaN gaps (a paused scrape)."""
    t = np.arange(n)
    x = base * (1.0 + 0.4 * np.sin(2 * np.pi * t / 17.0)) \
        + rng.normal(0.0, 0.05 * base, n)
    x[rng.random(n) < 0.05] = np.nan
    return x.astype(np.float32)


def _tables(n=60, retention=None, seed=0):
    rng = np.random.default_rng(seed)
    jt, tt = JTable(retention=retention), TrainingTable(retention=retention)
    for sid, base in zip(SERVICES, (100.0, 10.0, 50.0)):
        for v in _rps(rng, n, base):
            row = {"rps": float(v), "cores": 2.0}
            jt.append(sid, row)
            tt.append(sid, row)
    return jt, tt


@pytest.mark.parametrize("lags,horizon,since,retention", [
    (8, 1, None, None), (8, 1, 40, None), (3, 2, None, None),
    (4, 3, 55, None), (8, 1, 90, None), (5, 1, None, 16), (5, 1, 70, 16)])
def test_lagged_windows_equal_repros(lags, horizon, since, retention):
    jt, tt = _tables(n=80, retention=retention)
    for sid in SERVICES:
        want = jt.lagged_windows(sid, "rps", lags, horizon, since=since)
        got = tt.lagged_windows(sid, "rps", lags, horizon, since=since)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2] and got[0].dtype == np.float32


@pytest.mark.parametrize("n,lags", [(60, 8), (5, 8), (0, 4), (40, 1)])
def test_lag_tail_equals_repros(n, lags):
    jt, tt = _tables(n=n)
    for sid in SERVICES + ("edge-0/unknown/c0",):
        want, want_ok = jt.lag_tail(sid, "rps", lags)
        got, got_ok = tt.lag_tail(sid, "rps", lags)
        np.testing.assert_array_equal(got, want)
        assert got_ok == want_ok


def _forecasters(**kw):
    args = dict(services=SERVICES, types=TYPES, scales=(120.0, 12.0, 60.0),
                lags=8, horizon=1, row_capacity=64, ridge=1e-6, **kw)
    return jfc.LoadForecaster(**args), tfc.LoadForecaster(**args)


def _span(y):
    return max(float(np.nanmax(y) - np.nanmin(y)), 1.0)


def _check_fit(jf, tf, jw, tw, jt, tt, rps):
    """Predictions of both fits on every training window and on the
    current lag windows (with the gate blend) within 1e-4 of the span."""
    for i, sid in enumerate(SERVICES):
        X, Y, _ = jt.lagged_windows(sid, "rps", jf.lags, jf.horizon)
        want = np.asarray(jf.plan.stacked(jw).model(i).predict(X))
        got = tf.plan.stacked(tw).model(i).predict(X).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * _span(Y))
    jl, tl = jf.lag_matrix(jt), tf.lag_matrix(tt)
    np.testing.assert_array_equal(tl, jl)
    use = np.array([1.0, 0.0, 1.0], np.float32)
    jp, jeff = jf.predict_tracer(jw, jnp.asarray(jl), jnp.asarray(use),
                                 jnp.asarray(rps))
    tp, teff = tf.predict_tracer(tw, torch.from_numpy(tl),
                                 torch.from_numpy(use), torch.from_numpy(rps))
    span = np.maximum(np.abs(np.asarray(jp)), 1.0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=float(1e-4 * span.max()))
    np.testing.assert_allclose(teff.numpy(), np.asarray(jeff), rtol=0,
                               atol=float(1e-4 * span.max()))
    assert (teff.numpy()[1] == rps[1]) and (teff.numpy() >= rps).all()


def test_streaming_forecaster_fit_matches_repro():
    jt, tt = _tables(n=40)
    jf, tf = _forecasters()
    # first fit: the rebuild of the full lagged window, then a delta push
    jkind, jpairs = jf.prep(jt)
    tkind, tpairs = tf.prep(tt)
    assert jkind == tkind == "batch"
    for (jx, jy), (tx, ty) in zip(jpairs, tpairs):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    jf.state = jf.plan.stream_rebuild(jpairs)
    tf.state = tf.plan.stream_rebuild(tpairs)
    rng = np.random.default_rng(1)
    for sid, base in zip(SERVICES, (100.0, 10.0, 50.0)):
        for v in _rps(rng, 3, base):
            jt.append(sid, {"rps": float(v)})
            tt.append(sid, {"rps": float(v)})
    jprep, tprep = jf.prep(jt), tf.prep(tt)
    assert jprep[0] == tprep[0] == "delta"
    k = jf.delta_capacity(jprep)
    assert tf.delta_capacity(tprep) == k and tf.rows == jf.rows
    jd = jf.plan.fill_delta(jprep[1], k)
    td = tf.plan.fill_delta(tprep[1], k)
    np.testing.assert_array_equal(td, jd)
    js = jf.plan.stream_update_arrays(
        jf.state, *jf.plan.unpack_delta(jnp.asarray(jd), k))
    ts = tf.plan.stream_update_arrays(
        tf.state, *tf.plan.unpack_delta(torch.from_numpy(td), k))
    span = float(np.abs(np.asarray(js.gram)).max())
    np.testing.assert_allclose(ts.gram.numpy(), np.asarray(js.gram), rtol=0,
                               atol=1e-5 * span)
    jwp, jpl = jf.prior_arrays()
    twp, tpl = tf.prior_arrays()
    jw = jf.plan.stream_fit_arrays(js, jnp.asarray(jwp), jnp.asarray(jpl))
    tw = tf.plan.stream_fit_arrays(ts, torch.from_numpy(twp),
                                   torch.from_numpy(tpl))
    rps = np.array([90.0, 14.0, 40.0], np.float32)
    _check_fit(jf, tf, jw, tw, jt, tt, rps)


def test_batch_forecaster_fit_matches_repro():
    jt, tt = _tables(n=50, seed=3)
    jf, tf = _forecasters()
    jkind, jpairs = jf.prep(jt, streaming=False)
    tkind, tpairs = tf.prep(tt, streaming=False)
    assert jkind == tkind == "batch" and tf.cursors == jf.cursors
    jbuf = jf.plan.fill_packed(jpairs)
    tbuf = tf.plan.fill_packed(tpairs)
    np.testing.assert_array_equal(tbuf, jbuf)
    jp = jf.plan
    jw = fit_batched_arrays(*jp.unpack(jnp.asarray(jbuf)), jp._E, jp._tmask,
                            jp._nterms, jp._scale, jp.ridge, jp.max_degree)
    tw = tf.plan.fit_arrays(*tf.plan.unpack(torch.from_numpy(tbuf)))
    _check_fit(jf, tf, jw, tw, jt, tt, np.array([130.0, 2.0, 55.0],
                                                np.float32))


def _gate_state(fc):
    return ({s: list(d) for s, d in fc._errs.items()}, dict(fc._evals),
            sorted(fc._pending), fc.last_used, fc.last_err)


def test_hybrid_gate_matches_repro():
    jt, tt = _tables(n=30)
    jf, tf = _forecasters(min_evals=2, err_window=4, gate_tol=0.2)
    for fc, tab in ((jf, jt), (tf, tt)):
        fc.prep(tab)
        fc.lag_matrix(tab)
    rng = np.random.default_rng(5)
    trail = []
    for r in range(10, 22):
        obs = rng.uniform(5.0, 120.0, 3).astype(np.float32)
        pred = obs * rng.uniform(0.7, 1.3, 3).astype(np.float32)
        if r == 14:
            pred[1] = 10.0 * obs[1]              # one spike on cv-analyzer
        for fc in (jf, tf):
            fc.settle(r, obs)
            if r != 17:                          # a gap: nothing pending
                fc.note(r + 1, pred)
        masks = [jf.use_mask(), tf.use_mask()]
        np.testing.assert_array_equal(masks[1], masks[0])
        assert _gate_state(tf) == _gate_state(jf)
        trail.append(masks[1].copy())
    assert any(m.sum() for m in trail) and any(m.sum() < 3 for m in trail)
    for fc in (jf, tf):
        fc.inject_error(1.0)                     # chaos hook: gate shut
    np.testing.assert_array_equal(tf.use_mask(), jf.use_mask())
    assert tf.use_mask().sum() == 0 and _gate_state(tf) == _gate_state(jf)
    # a rebuild with the same services inherits the track record
    jn, tn = _forecasters(min_evals=2, err_window=4, gate_tol=0.2)
    jn.inherit_gate(jf)
    tn.inherit_gate(tf)
    assert _gate_state(tn) == _gate_state(jn)


def test_transfer_priors_match_repro():
    priors = {"qr-detector": np.linspace(-0.2, 0.9, 9).astype(np.float32),
              "*": np.full(9, 0.1, np.float32)}
    jf, tf = _forecasters(priors=priors, prior_strength=0.5,
                          min_prior_rows=3)
    for fc, rows in ((jf, [0, 2, 5]), (tf, [0, 2, 5])):
        fc.rows = list(rows)
    for (jw, jp), (tw, tp) in [(jf.prior_arrays(), tf.prior_arrays())]:
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tp, np.float32([0.5, 0.5 / 3, 0.0]))
    assert tfc.LoadForecaster(SERVICES, TYPES, (1, 1, 1), 8, 1,
                              64).type_means() == {}
    W = np.random.default_rng(2).normal(size=(3, 9)).astype(np.float32)
    jf.last_w, tf.last_w = jnp.asarray(W), torch.from_numpy(W)
    want, got = jf.type_means(), tf.type_means()
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


def _gru_params(seed=0, n_hidden=8):
    return jfc.gru_init(jax.random.PRNGKey(seed), n_hidden)


@pytest.mark.parametrize("n_hidden,lags", [(8, 8), (4, 12)])
def test_gru_predict_matches_repro(n_hidden, lags):
    params = _gru_params(1, n_hidden)
    tparams = tfc.gru_params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()})
    X = np.random.default_rng(0).uniform(-1, 2, (16, lags)).astype(
        np.float32)
    want = np.asarray(jax.vmap(lambda w: jfc.gru_predict(params, w))(X))
    got = tfc.gru_predict(tparams, X).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    one = tfc.gru_predict(tparams, X[3])
    assert one.shape == () and abs(float(one) - want[3]) <= 1e-5
    gen = tfc.gru_init(torch.Generator().manual_seed(0), n_hidden)
    assert {k: tuple(v.shape) for k, v in gen.items()} == \
        {k: tuple(np.shape(v)) for k, v in params.items()}


def test_fit_gru_losses_match_repro(monkeypatch):
    rng = np.random.default_rng(4)
    series = (np.sin(np.arange(80) / 5.0) + 0.05 * rng.normal(size=80)
              ).astype(np.float32)
    X = np.lib.stride_tricks.sliding_window_view(series[:-1], 6)
    Y = series[6:]
    jparams, jlosses = jfc.fit_gru(X, Y, n_hidden=8, steps=60, lr=0.1,
                                   seed=0)
    init = {k: np.asarray(v) for k, v in _gru_params(0).items()}
    monkeypatch.setattr(tfc, "gru_init", lambda gen, n_hidden=8, n_in=1:
                        tfc.gru_params_from_numpy(init))
    tparams, tlosses = tfc.fit_gru(X, Y, n_hidden=8, steps=60, lr=0.1,
                                   seed=0)
    assert len(tlosses) == len(jlosses) == 60
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < 0.5 * tlosses[0]
    for k in init:
        np.testing.assert_allclose(tparams[k].numpy(),
                                   np.asarray(jparams[k]), rtol=1e-3,
                                   atol=1e-4)
