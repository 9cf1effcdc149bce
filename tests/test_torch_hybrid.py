"""The port's hybrid program (jamba-1.5-large-398b's ``.smoke()`` cut: 8
layers = one period of [attention, Mamba-2 x 7], an MoE FFN of 4 experts
top-2 on every other sublayer, d_model 64, 4 heads on 2 kv heads) against
the JAX package's, on the CPU in float32.

Both packages compute with one set of weights: ``repro``'s
``Model.init(PRNGKey(0))``, handed to the port through
``params_from_numpy``. Inputs are made with numpy from a seed.

The port's cache folds ``repro``'s (n_periods, P-1) Mamba-2 state axes
into one, so the batch is axis 1 of every leaf; the tests reshape
``repro``'s to compare.

Tolerances: 1e-4 on logits and states, the float32 bar of
``tests/test_torch_model.py`` (observed ~1e-5: seven SSD scans in another
summation order); the aux loss 1e-5 relative. Routing is integer
arithmetic on a float32 top-k: the tests that compare it compare exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.models import build as jax_build
from repro.models import moe as jax_moe
from repro.models import transformer as jax_transformer
from repro.serve import engine as jax_engine
from repro_torch.configs import get
from repro_torch.launch import serve as launch_serve
from repro_torch.models import ModelConfig, build, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import rope_angles
from repro_torch.models.moe import moe, recording_routes
from repro_torch.serve.engine import EngineConfig, Request, ServingEngine

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "jamba-1.5-large-398b"


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get(ARCH).smoke()
    cfg = get(ARCH).smoke()
    jmodel = jax_build(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, build(cfg), params, cfg


def _folded(a):
    """``repro``'s (n_periods, P-1, B, ...) state -> the port's
    (n_periods * (P-1), B, ...)."""
    a = np.asarray(a)
    return a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])


@pytest.mark.parametrize("name,overrides", [
    (ARCH, {}), (ARCH, {"n_layers": 8}), (ARCH, {"moe_every": 3}),
    (ARCH, {"attn_period": 4, "n_layers": 12})])
def test_hybrid_layout_matches_repro(name, overrides):
    jcfg = dataclasses.replace(jax_get(name), **overrides)
    cfg = dataclasses.replace(get(name), **overrides)
    assert transformer._hybrid_layout(cfg) == \
        jax_transformer._hybrid_layout(jcfg)


def test_hybrid_layout_refuses_a_partial_period():
    cfg = dataclasses.replace(get(ARCH), n_layers=12)
    with pytest.raises(ValueError, match="multiple of attn_period"):
        transformer._hybrid_layout(cfg)


def test_hybrid_period_matches_repro(pair):
    """One period over a 20-token prompt: the output, the aux loss and the
    caches it returns (the prompt's K/V, each Mamba-2 sublayer's states)."""
    _, jparams, _, params, cfg = pair
    x = np.random.default_rng(0).normal(size=(2, 20, cfg.d_model)).astype(
        np.float32)
    positions = jnp.broadcast_to(jnp.arange(20)[None], (2, 20))
    jpp = jax.tree.map(lambda a: a[0], jparams["periods"])
    jx, jaux, jnew = jax_transformer._hybrid_period(cfg, jpp, jnp.asarray(x),
                                                    positions)
    rot = rope_angles(torch.arange(20).expand(2, 20), cfg.d_head,
                      cfg.rope_theta)
    tx, aux, new = transformer._hybrid_period(cfg, params["periods"][0],
                                              torch.from_numpy(x), rot)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(new["kv"][0].numpy(), np.asarray(jnew["kv_k"]),
                               **TOL)
    np.testing.assert_allclose(new["kv"][1].numpy(), np.asarray(jnew["kv_v"]),
                               **TOL)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(torch.stack(new[key]).numpy(),
                                   np.asarray(jnew[key]), **TOL)


def test_forward_logits_and_aux_match_repro(pair):
    _, jparams, _, params, cfg = pair
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 24))
    jl, jaux, _ = jax_transformer.hybrid_forward(jparams, cfg,
                                                 jnp.asarray(toks))
    tl, aux, _ = transformer.hybrid_forward(params, cfg,
                                            torch.from_numpy(toks))
    assert tl.shape == (2, 24, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert float(aux) > 0


@pytest.mark.parametrize("S", [20, 37])
def test_prefill_and_decode_match_repro(pair, S):
    """Prefill (37 tokens: three chunks of 16, a dt = 0 tail), the cache
    leaf by leaf, then 4 decode steps of 2 rows."""
    jmodel, jparams, model, params, cfg = pair
    toks = np.random.default_rng(S).integers(0, cfg.vocab, (2, S))
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            max_seq=64)
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           max_seq=64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for key in ("kv_k", "kv_v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(tc[key].numpy(), _folded(jc[key]), **TOL)
    assert tc["pos"].tolist() == [S, S]
    jdecode = jax.jit(jmodel.decode)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl, -1))
        assert nxt.tolist() == torch.argmax(tl, -1).tolist()
        jl, jc = jdecode(jparams, jnp.asarray(nxt[:, None], jnp.int32), jc)
        tl, tc = model.decode(params, torch.from_numpy(nxt[:, None].copy()),
                              tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["ssm"].numpy(), _folded(jc["ssm"]), **TOL)
    assert tc["pos"].tolist() == [S + 4, S + 4]


def test_decode_matches_teacher_forcing(pair):
    """A 12-token prefill and 6 decode steps give the forward's logits at
    those positions (one row, no route dropped in the forward: a decode
    step routes each token alone)."""
    _, _, model, params, cfg = pair
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, 18)))
    with recording_routes() as routes:
        want, _, _ = transformer.hybrid_forward(params, cfg, toks)
    assert all(bool(keep.all()) for _, keep in routes)
    logits, cache = model.prefill(params, {"tokens": toks[:, :12]},
                                  max_seq=32)
    np.testing.assert_allclose(logits.numpy(), want[:, 11].numpy(), **TOL)
    for t in range(12, 18):
        logits, cache = model.decode(params, toks[:, t:t + 1], cache)
        np.testing.assert_allclose(logits.numpy(), want[:, t].numpy(), **TOL)


def test_ragged_last_group_routes_the_remainder_alone():
    """``ragged=True`` routes 40 tokens as groups of 16, 16 and 8, each
    with its own capacity: ``repro``'s routing of the first 32 in groups
    of 16 and of the last 8 as one group; the aux loss is over all 40.
    Without it, 40 tokens in groups of 16 still raise."""
    cfg = ModelConfig(name="tiny-moe", family="moe", n_layers=1, d_model=32,
                      n_heads=2, n_kv_heads=2, d_head=16, d_ff=48, vocab=64,
                      n_experts=4, top_k=2)
    rng = np.random.default_rng(3)
    w = {"router": rng.normal(size=(32, 4)) * 32 ** -0.5,
         "up": rng.normal(size=(4, 32, 48)) * 32 ** -0.5,
         "gate": rng.normal(size=(4, 32, 48)) * 32 ** -0.5,
         "down": rng.normal(size=(4, 48, 32)) * 48 ** -0.5}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.normal(size=(1, 40, 32)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, w)
    y_head, _ = jax_moe.moe(jp, jnp.asarray(x[:, :32]), cfg, group_size=16)
    y_tail, _ = jax_moe.moe(jp, jnp.asarray(x[:, 32:]), cfg, group_size=16)
    tp = {k: torch.from_numpy(v) for k, v in w.items()}
    with recording_routes() as routes:
        y, aux = moe(tp, torch.from_numpy(x), cfg, group_size=16,
                     ragged=True)
    np.testing.assert_allclose(
        y.numpy(), np.concatenate([y_head, y_tail], axis=1),
        rtol=1e-5, atol=1e-6)
    (idx, keep), = routes
    assert idx.shape == keep.shape == (40, 2)
    probs = torch.softmax(torch.from_numpy(x[0]) @ tp["router"], dim=-1)
    frac = torch.nn.functional.one_hot(idx[:, 0], 4).float().mean(0)
    np.testing.assert_allclose(float(aux),
                               float(4 * (frac * probs.mean(0)).sum()),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="groups of 16"):
        moe(tp, torch.from_numpy(x), cfg, group_size=16)


def test_cache_puts_the_batch_on_axis_one(pair):
    jmodel, _, model, _, cfg = pair
    got = model.init_cache(3, 40, "cpu")
    want = jmodel.init_cache(3, 40)
    for key, val in got.items():
        if key == "pos":
            assert val.tolist() == [0, 0, 0]
            continue
        assert val.shape[1] == 3
        shape = tuple(want[key].shape)
        if key in ("conv", "ssm"):
            shape = (shape[0] * shape[1],) + shape[2:]
        assert tuple(val.shape) == shape


def _requests(cls, vocab, lengths, max_new, seed, n):
    rng = np.random.default_rng(seed)
    return [cls(rid, rng.integers(0, vocab, lengths[rid % len(lengths)])
                .astype(np.int32), max_new_tokens=max_new[rid % len(max_new)])
            for rid in range(n)]


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    for _ in range(200):
        engine.step()
        if len(engine.completed) == len(reqs):
            break
    assert len(engine.completed) == len(reqs)
    return {r.rid: list(r.generated) for r in engine.completed}


def test_engine_streams_match_repro(pair):
    """Seeded token streams of 5 requests through 2 slots, exact-length
    prompts of 9 and 21 tokens (the engine copies each admitted prompt's
    cache into its slot along axis 1)."""
    jmodel, jparams, model, params, cfg = pair
    lengths, max_new = [21, 9], [5, 3, 4]
    ecfg = dict(slots=2, max_seq=40, context=32, chips=4.0)
    want = _serve(jax_engine.ServingEngine(jmodel, jparams,
                                           jax_engine.EngineConfig(**ecfg)),
                  _requests(jax_engine.Request, cfg.vocab, lengths, max_new,
                            9, n=5))
    got = _serve(ServingEngine(model, params, EngineConfig(**ecfg),
                               device="cpu"),
                 _requests(Request, cfg.vocab, lengths, max_new, 9, n=5))
    assert got == want


def test_launcher_serves_jamba_on_cpu():
    engine = launch_serve.main(["--arch", ARCH, "--device", "cpu",
                                "--requests", "3", "--prompt-len", "12",
                                "--max-new", "4", "--slots", "2"])
    assert engine.model.cfg.name == f"{ARCH}-smoke"
    assert len(engine.completed) == 3
    assert all(len(r.generated) == 4 for r in engine.completed)


def test_jamba_builds_at_full_width():
    cfg = get(ARCH)
    model = build(cfg)
    assert model.cfg.family == "hybrid" and not model.supports_padded_prefill
    assert cfg.n_params() == jax_get(ARCH).n_params()
