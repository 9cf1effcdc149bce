"""The port's MoE FFN (``repro_torch/models/moe.py``) and the MoE decoder
(qwen2-moe-a2.7b's ``.smoke()`` cut) against the JAX package's, on the CPU.

Both packages compute with one set of weights, made with numpy from a seed
(``repro``'s layout: router (d, E) float32, up/gate (E, d, f), down (E, f,
d), the shared expert an MLP of (in, out) linears, which the port stores
(out, in)).

Tolerances:
 * float32 ``moe``: rtol 1e-5, atol 1e-6. Both run the same float32
   arithmetic; only summation orders differ (~1e-7 relative a product);
 * bf16 ``moe``: atol 3e-2 on outputs of magnitude ~1. The expert
   products round h, the gate, their product and the combine weights to
   bf16 (8 bits of mantissa, 4e-3 relative); two summation orders part a
   product by up to one bf16 ulp, which the next product carries;
 * decoder logits: 1e-4, the bar of ``tests/test_torch_model.py``.

Routing is integer arithmetic on the float32 router's top-k, so the kept
routes must be identical, not close. ``repro``'s kept set is read from
its output: a token whose route was dropped changes its output when the
capacity is lifted, a token without a drop does not.
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
from repro.serve import engine as jax_engine
from repro_torch.configs import get
from repro_torch.models import ModelConfig, build, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.moe import capacity, moe, recording_routes
from repro_torch.serve.engine import EngineConfig, Request, ServingEngine

torch.set_num_threads(1)
F32 = dict(rtol=1e-5, atol=1e-6)
BF16_ATOL = 3e-2
LOGITS = dict(rtol=1e-4, atol=1e-4)


def _cfg(e=8, k=2, shared=1, d=32, f=48):
    return ModelConfig(name="tiny-moe", family="moe", n_layers=1, d_model=d,
                       n_heads=2, n_kv_heads=2, d_head=16, d_ff=f, vocab=64,
                       n_experts=e, top_k=k, n_shared_experts=shared)


def _weights(cfg, seed):
    """Numpy weights in ``repro``'s layout, and the same for the port."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    w = {"router": rng.normal(size=(d, e)) * d ** -0.5,
         "up": rng.normal(size=(e, d, f)) * d ** -0.5,
         "gate": rng.normal(size=(e, d, f)) * d ** -0.5,
         "down": rng.normal(size=(e, f, d)) * f ** -0.5}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        w["shared"] = {
            "up": {"w": (rng.normal(size=(d, fs)) * d ** -0.5)
                   .astype(np.float32)},
            "gate": {"w": (rng.normal(size=(d, fs)) * d ** -0.5)
                     .astype(np.float32)},
            "down": {"w": (rng.normal(size=(fs, d)) * fs ** -0.5)
                     .astype(np.float32)}}
    return w


def _jax_params(w, dtype):
    def leaf(name, a):
        return jnp.asarray(a, jnp.float32 if name == "router" else dtype)
    return {k: (jax.tree.map(lambda a: jnp.asarray(a, dtype), v)
                if isinstance(v, dict) else leaf(k, v)) for k, v in w.items()}


def _port_params(w, dtype):
    def leaf(name, a):
        return torch.from_numpy(a).to(torch.float32 if name == "router"
                                      else dtype)
    p = {k: leaf(k, v) for k, v in w.items() if k != "shared"}
    if "shared" in w:
        p["shared"] = {k: {"w": torch.from_numpy(v["w"].T.copy()).to(dtype)}
                       for k, v in w["shared"].items()}
    return p


def _run_both(cfg, w, x, dtype=torch.float32, jdtype=jnp.float32, **kw):
    jy, jaux = jax.jit(lambda p, x: jax_moe.moe(p, x, cfg, **kw))(
        _jax_params(w, jdtype), jnp.asarray(x, jdtype))
    with recording_routes() as routes:
        y, aux = moe(_port_params(w, dtype), torch.from_numpy(x).to(dtype),
                     cfg, **kw)
    (idx, keep), = routes
    return (np.asarray(jy.astype(jnp.float32)), float(jaux),
            y.float().numpy(), float(aux), idx.numpy(), keep.numpy())


def _assign(idx, cap, e, routed=None):
    """GShard's sequential-choice assignment of one group, route by route:
    every token's choice c before any token's choice c + 1, tokens in
    order; a route is kept while its expert has room. ``routed`` (T,)
    leaves tokens out of the routing altogether."""
    T, k = idx.shape
    counts, keep = np.zeros(e, int), np.zeros((T, k), bool)
    for c in range(k):
        for t in range(T):
            if routed is not None and not routed[t]:
                continue
            if counts[idx[t, c]] < cap:
                keep[t, c] = True
                counts[idx[t, c]] += 1
    return keep


def _jax_top_k(w, x, cfg):
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32).reshape(
        -1, cfg.d_model) @ jnp.asarray(w["router"]), axis=-1)
    return np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])


@pytest.mark.parametrize("e,k,shared,B,S", [(8, 2, 1, 2, 24),
                                            (8, 2, 0, 1, 40),
                                            (6, 3, 2, 3, 16)])
def test_moe_matches_repro_float32(e, k, shared, B, S):
    """No route dropped (tg <= 16 or capacity to spare): outputs, the
    shared expert's share and the Switch aux loss equal ``repro``'s."""
    cfg = _cfg(e=e, k=k, shared=shared)
    w = _weights(cfg, seed=e + k + shared)
    x = np.random.default_rng(1).normal(size=(B, S, cfg.d_model)) \
        .astype(np.float32)
    jy, jaux, y, aux, idx, keep = _run_both(cfg, w, x, capacity_factor=4.0)
    np.testing.assert_allclose(y, jy, **F32)
    np.testing.assert_allclose(aux, jaux, **F32)
    assert keep.all()
    np.testing.assert_array_equal(idx, _jax_top_k(w, x, cfg))


def test_shared_expert_is_added_to_the_routed_output():
    cfg = _cfg(shared=2)
    w = _weights(cfg, seed=3)
    x = np.random.default_rng(2).normal(size=(1, 16, cfg.d_model)) \
        .astype(np.float32)
    with_shared = moe(_port_params(w, torch.float32), torch.from_numpy(x),
                      cfg)[0]
    routed = dataclasses.replace(cfg, n_shared_experts=0)
    no_shared = {k: v for k, v in w.items() if k != "shared"}
    alone = moe(_port_params(no_shared, torch.float32), torch.from_numpy(x),
                routed)[0]
    jy, _ = jax_moe.moe(_jax_params(no_shared, jnp.float32), jnp.asarray(x),
                        routed)
    np.testing.assert_allclose(alone.numpy(), np.asarray(jy), **F32)
    assert (with_shared - alone).abs().max() > 0.1


def test_moe_matches_repro_bf16():
    cfg = _cfg(e=8, k=2, shared=1, d=64, f=96)
    w = _weights(cfg, seed=7)
    x = np.random.default_rng(3).normal(size=(2, 32, cfg.d_model)) \
        .astype(np.float32)
    jy, jaux, y, aux, idx, keep = _run_both(
        cfg, w, x, dtype=torch.bfloat16, jdtype=jnp.bfloat16)
    np.testing.assert_array_equal(
        idx, _jax_top_k(w, np.asarray(jnp.asarray(x, jnp.bfloat16)
                                      .astype(jnp.float32)), cfg))
    np.testing.assert_array_equal(keep, _assign(idx, capacity(64, cfg),
                                                cfg.n_experts))
    assert np.abs(y - jy).max() <= BF16_ATOL, np.abs(y - jy).max()
    np.testing.assert_allclose(aux, jaux, rtol=1e-5)


def _dropped_tokens(cfg, w, x, y_of):
    """Tokens whose output moves when the capacity is lifted: those with a
    dropped route."""
    tight = y_of(capacity_factor=1.0).reshape(-1, cfg.d_model)
    loose = y_of(capacity_factor=100.0).reshape(-1, cfg.d_model)
    return np.abs(tight - loose).max(-1) > 1e-5


def test_capacity_drops_the_same_routes_as_repro():
    """One group of 64 tokens, 4 experts top-2, capacity factor 1.0: cap
    32 against a mean load of 32, so the busier experts overflow."""
    cfg = _cfg(e=4, k=2, shared=1)
    w = _weights(cfg, seed=11)
    x = np.random.default_rng(4).normal(size=(1, 64, cfg.d_model)) \
        .astype(np.float32)
    jy, jaux, y, aux, idx, keep = _run_both(cfg, w, x, capacity_factor=1.0)
    np.testing.assert_allclose(y, jy, **F32)
    np.testing.assert_allclose(aux, jaux, **F32)
    cap = capacity(64, cfg, 1.0)
    assert cap == 32
    np.testing.assert_array_equal(keep, _assign(idx, cap, cfg.n_experts))
    assert (~keep).sum() > 0
    jdropped = _dropped_tokens(cfg, w, x, lambda **kw: _run_both(
        cfg, w, x, **kw)[0])
    np.testing.assert_array_equal(jdropped, ~keep.all(-1))


def test_right_padded_prompt_pads_push_real_routes_out_as_in_repro():
    """A 40-token prompt right-padded to a 64-token group: the 24 pads
    share one hidden state, so they all route to the same two experts.
    They come after the real tokens at choice 0, but their routes count
    against the capacity at choice 1, where they push real tokens out.
    The port reproduces ``repro`` exactly, drops included."""
    cfg = _cfg(e=4, k=2, shared=0)
    w = _weights(cfg, seed=5)
    rng = np.random.default_rng(6)
    n = 40
    x = rng.normal(size=(1, 64, cfg.d_model)).astype(np.float32)
    x[0, n:] = rng.normal(size=cfg.d_model).astype(np.float32) * 3.0
    jy, _, y, _, idx, keep = _run_both(cfg, w, x, capacity_factor=1.0)
    np.testing.assert_allclose(y, jy, **F32)
    cap = capacity(64, cfg, 1.0)
    np.testing.assert_array_equal(keep, _assign(idx, cap, cfg.n_experts))
    real = np.arange(64) < n
    without_pads = _assign(idx, cap, cfg.n_experts, routed=real)
    pushed = without_pads[:n] & ~keep[:n]
    assert pushed[:, 0].sum() == 0           # choice 0: pads come last
    assert pushed[:, 1:].sum() > 0, "no real route pushed out by the pads"
    jdropped = _dropped_tokens(cfg, w, x, lambda **kw: _run_both(
        cfg, w, x, **kw)[0])
    np.testing.assert_array_equal(jdropped, ~keep.all(-1))


def test_tokens_that_do_not_split_into_groups_raise():
    cfg = _cfg()
    w = _weights(cfg, seed=0)
    x = np.zeros((1, 24, cfg.d_model), np.float32)
    with pytest.raises(ValueError, match="groups of 16"):
        moe(_port_params(w, torch.float32), torch.from_numpy(x), cfg,
            group_size=16)
    with pytest.raises(AssertionError):
        jax_moe.moe(_jax_params(w, jnp.float32), jnp.asarray(x), cfg,
                    group_size=16)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get("qwen2-moe-a2.7b").smoke()
    cfg = get("qwen2-moe-a2.7b").smoke()
    jmodel = jax_build(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, build(cfg), params, cfg


def test_decoder_forward_logits_and_aux_match_repro(pair):
    from repro.models import transformer as jax_transformer
    jmodel, jparams, _, params, cfg = pair
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 32))
    jl, jaux, _ = jax_transformer.decoder_forward(jparams, jmodel.cfg,
                                                  jnp.asarray(toks))
    tl, aux, _ = transformer.decoder_forward(params, cfg,
                                             torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    np.testing.assert_allclose(float(aux), float(jaux), **F32)
    assert float(aux) > 0


@pytest.mark.parametrize("S,length", [(24, None), (64, 45)])
def test_decoder_prefill_and_decode_match_repro(pair, S, length):
    """Exact-length and right-padded prefill (64 tokens in one group, cap
    40 against a mean load of 32), then 4 decode steps of 2 rows."""
    jmodel, jparams, model, params, cfg = pair
    toks = np.random.default_rng(S).integers(0, cfg.vocab, (2, S))
    if length is not None:
        toks[:, length:] = 0
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            max_seq=96,
                            length=None if length is None
                            else jnp.int32(length))
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           max_seq=96, length=length)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    jdecode = jax.jit(jmodel.decode)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl, -1))
        assert nxt.tolist() == torch.argmax(tl, -1).tolist()
        jl, jc = jdecode(jparams, jnp.asarray(nxt[:, None], jnp.int32), jc)
        tl, tc = model.decode(params, torch.from_numpy(nxt[:, None].copy()),
                              tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)


def test_padded_prefill_records_the_pads_routes(pair):
    """The route log holds one (T, k) entry a layer, pads included."""
    _, _, model, params, cfg = pair
    toks = torch.zeros((1, 64), dtype=torch.long)
    toks[0, :45] = torch.arange(1, 46)
    with recording_routes() as routes:
        model.prefill(params, {"tokens": toks}, max_seq=96, length=45)
    assert len(routes) == cfg.n_layers
    for idx, keep in routes:
        assert idx.shape == keep.shape == (64, cfg.top_k)


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
    """Seeded token streams of 7 requests through 3 slots, prompts of 9 to
    40 tokens padded to their buckets (up to 64: cap 40 a group)."""
    jmodel, jparams, model, params, cfg = pair
    lengths, max_new = [20, 40, 9, 33, 17], [5, 3, 6]
    ecfg = dict(slots=3, max_seq=96, context=48, chips=4.0)
    want = _serve(jax_engine.ServingEngine(jmodel, jparams,
                                           jax_engine.EngineConfig(**ecfg)),
                  _requests(jax_engine.Request, cfg.vocab, lengths, max_new,
                            9, n=7))
    got = _serve(ServingEngine(model, params, EngineConfig(**ecfg),
                               device="cpu"),
                 _requests(Request, cfg.vocab, lengths, max_new, 9, n=7))
    assert got == want
