"""The port's encoder-decoder (whisper-large-v3's ``.smoke()`` cut: 2
encoder and 2 decoder layers, d_model 64, 4 heads on 2 kv heads, d_head
16, LayerNorm, tanh GELU, biased projections, tied embeddings) and
gemma3-1b's mixed local:global cache against the JAX package's, on the
CPU in float32.

Both packages compute with one set of weights: ``repro``'s
``Model.init``, with its zero biases and unit LayerNorm scales replaced by
seeded numpy draws (so that a bias or a scale left out would show),
handed to the port through ``params_from_numpy``. Inputs are made with
numpy from a seed.

Tolerance: 1e-4 in float32 on logits and states, the bar of
``tests/test_torch_model.py`` (the same float32 arithmetic in another
summation order; the observed gaps are ~1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.models import build as jax_build
from repro.models import layers as jax_layers
from repro.models import transformer as jax_transformer
from repro_torch.configs import get
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build, layers, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import EngineConfig, ServingEngine
from torch_weights import perturbed

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get("whisper-large-v3").smoke()
    cfg = get("whisper-large-v3").smoke()
    jmodel = jax_build(jcfg)
    tree = perturbed(jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0))), np.random.default_rng(1))
    jparams = jax.tree.map(jnp.asarray, tree)
    return jmodel, jparams, build(cfg), params_from_numpy(cfg, tree), cfg


def _frames(cfg, B, T, seed):
    return np.random.default_rng(seed).normal(
        size=(B, T, cfg.d_model)).astype(np.float32)


def test_layernorm_matches_repro():
    rng = np.random.default_rng(0)
    x = (3 + 2 * rng.normal(size=(2, 5, 48))).astype(np.float32)
    p = {"scale": rng.normal(size=48).astype(np.float32),
         "bias": rng.normal(size=48).astype(np.float32)}
    want = jax_layers.norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           "layernorm")
    got = layers.norm({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), "layernorm")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert set(layers.init_norm(48, torch.float32, "cpu", "layernorm")) \
        == {"scale", "bias"}


def test_biased_linear_matches_repro():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(24, 40)).astype(np.float32)        # (in, out)
    b = rng.normal(size=40).astype(np.float32)
    x = rng.normal(size=(3, 24)).astype(np.float32)
    want = jax_layers.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                             jnp.asarray(x))
    got = layers.linear({"w": torch.from_numpy(w.T.copy()),
                         "b": torch.from_numpy(b)}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    p = layers.init_linear(torch.Generator().manual_seed(0), 24, 40,
                           torch.float32, bias=True)
    assert p["w"].shape == (40, 24) and p["b"].shape == (40,)
    assert not p["b"].any()


def test_sinusoid_positions_match_repro():
    want = np.asarray(jax_transformer.sinusoid_positions(448, 64,
                                                         jnp.float32))
    got = transformer.sinusoid_positions(448, 64, torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("S,T", [(1, 40), (5, 40), (7, 7)])
def test_cross_kv_and_cross_attention_match_repro(pair, S, T):
    """One query a row (the decode kernel's path) and a prompt (flash, not
    causal) against ``repro``'s unmasked attention."""
    _, jparams, _, params, cfg = pair
    rng = np.random.default_rng(S + T)
    enc = rng.normal(size=(2, T, cfg.d_model)).astype(np.float32)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["dec_layers"]["cross"])
    tp = params["dec_layers"][0]["cross"]
    jkv = jax_layers.cross_kv(jp, cfg, jnp.asarray(enc))
    tkv = layers.cross_kv(tp, cfg, torch.from_numpy(enc))
    for j, t in zip(jkv, tkv):
        assert t.shape == (2, T, cfg.n_kv_heads, cfg.d_head)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    want = jax_layers.cross_attention(jp, jnp.asarray(x), cfg, jkv)
    got = layers.cross_attention(tp, torch.from_numpy(x), cfg, tkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_not_causal_matches_repro(pair):
    _, jparams, _, params, cfg = pair
    x = np.random.default_rng(3).normal(size=(2, 11, cfg.d_model)).astype(
        np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["enc_layers"]["attn"])
    positions = jnp.broadcast_to(jnp.arange(11)[None], (2, 11))
    want, _ = jax_layers.attention(jp, jnp.asarray(x), cfg,
                                   positions=positions, causal=False,
                                   use_rope=False)
    got, (k, v) = layers.attention(params["enc_layers"][1]["attn"],
                                   torch.from_numpy(x), cfg, rot=None,
                                   causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    causal, _ = layers.attention(params["enc_layers"][1]["attn"],
                                 torch.from_numpy(x), cfg, rot=None)
    assert not np.allclose(causal.numpy(), got.numpy(), atol=1e-3)
    assert k.shape == v.shape == (2, 11, cfg.n_kv_heads, cfg.d_head)


def test_encode_matches_repro(pair):
    _, jparams, _, params, cfg = pair
    frames = _frames(cfg, 2, 40, seed=4)
    want = jax_transformer.encdec_encode(jparams, cfg, jnp.asarray(frames))
    got = transformer.encdec_encode(params, cfg, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_logits_match_repro(pair):
    _, jparams, _, params, cfg = pair
    frames = _frames(cfg, 2, 40, seed=5)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 9))
    want, jaux, _ = jax_transformer.encdec_forward(
        jparams, cfg, jnp.asarray(frames), jnp.asarray(toks))
    got, aux, _ = transformer.encdec_forward(
        params, cfg, torch.from_numpy(frames), torch.from_numpy(toks))
    assert got.shape == (2, 9, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == float(jaux) == 0.0


def test_prefill_and_three_decode_steps_match_repro(pair):
    """The caches too: the self K/V at 448 positions, the cross K/V sized
    by the encoder's 40 frames, not by ``max_seq``."""
    jmodel, jparams, model, params, cfg = pair
    frames = _frames(cfg, 2, 40, seed=6)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 4))
    jl, jc = jmodel.prefill(jparams, {"frames": jnp.asarray(frames),
                                      "tokens": jnp.asarray(toks)},
                            max_seq=40)
    tl, tc = model.prefill(params, {"frames": torch.from_numpy(frames),
                                    "tokens": torch.from_numpy(toks)},
                           max_seq=1024)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["k"].shape == (cfg.n_layers, 2, 448, cfg.n_kv_heads,
                             cfg.d_head)
    assert tc["cross_k"].shape == (cfg.n_layers, 2, 40, cfg.n_kv_heads,
                                   cfg.d_head)
    for key in ("k", "v", "cross_k", "cross_v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)
    assert tc["pos"].tolist() == [4, 4]
    jdecode = jax.jit(jmodel.decode)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1))
        assert nxt.tolist() == torch.argmax(tl, -1).tolist()
        jl, jc = jdecode(jparams, jnp.asarray(nxt[:, None], jnp.int32), jc)
        tl, tc = model.decode(params, torch.from_numpy(nxt[:, None].copy()),
                              tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    assert tc["pos"].tolist() == [7, 7]


def test_rows_decode_at_their_own_positions(pair):
    """Two clips prefilled apart (prompts of 3 and 6 tokens) decode as one
    batch, each row at its own position, as ``repro`` decodes each."""
    jmodel, jparams, model, params, cfg = pair
    frames = _frames(cfg, 2, 24, seed=7)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, (1, n)) for n in (3, 6)]
    jrows, trows = [], []
    for b, toks in enumerate(prompts):
        jrows.append(jmodel.prefill(jparams, {
            "frames": jnp.asarray(frames[b:b + 1]),
            "tokens": jnp.asarray(toks)}, max_seq=24))
        trows.append(model.prefill(params, {
            "frames": torch.from_numpy(frames[b:b + 1]),
            "tokens": torch.from_numpy(toks)}, max_seq=24))
    cache = {k: torch.cat([c[k] for _, c in trows],
                          dim=0 if k == "pos" else 1) for k in trows[0][1]}
    logits = torch.cat([tl for tl, _ in trows])
    jdecode = jax.jit(jmodel.decode)
    for _ in range(3):
        nxt = torch.argmax(logits, -1)
        logits, cache = model.decode(params, nxt[:, None], cache)
        for b, (jl, jc) in enumerate(jrows):
            assert int(jnp.argmax(jl[0])) == int(nxt[b])
            jl, jc = jdecode(jparams, jnp.asarray([[int(nxt[b])]]), jc)
            jrows[b] = (jl, jc)
            np.testing.assert_allclose(logits[b].numpy(), np.asarray(jl[0]),
                                       **TOL)
    assert cache["pos"].tolist() == [6, 9]


def test_init_cache_matches_repro_shapes(pair):
    jmodel, _, model, _, cfg = pair
    want = jmodel.init_cache(3, 50)
    got = model.init_cache(3, 50, "cpu")
    for key in ("k", "v", "cross_k", "cross_v"):
        assert tuple(got[key].shape) == tuple(want[key].shape)
        assert not got[key].any()
    assert got["pos"].tolist() == [0, 0, 0]


def test_engine_and_launcher_refuse_whisper(pair):
    _, _, model, params, _ = pair
    with pytest.raises(ValueError, match="no audio frames"):
        ServingEngine(model, params, EngineConfig(), device="cpu")
    with pytest.raises(ValueError, match="no audio frames"):
        launch_serve.main(["--arch", "whisper-large-v3", "--device", "cpu",
                           "--requests", "1"])


def test_whisper_builds_at_full_width():
    cfg = get("whisper-large-v3")
    model = build(cfg)
    assert model.cfg.family == "encdec" and not model.supports_padded_prefill
    assert cfg.n_params() == jax_get("whisper-large-v3").n_params()


# -- gemma3-1b's mixed local:global cache ----------------------------------------

@pytest.fixture(scope="module")
def mixed_pair():
    jcfg = dataclasses.replace(jax_get("gemma3-1b").smoke(), dtype="float32",
                               mixed_cache=True)
    cfg = dataclasses.replace(get("gemma3-1b").smoke(), dtype="float32",
                              mixed_cache=True)
    jmodel = jax_build(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, build(cfg), params, cfg


def test_mixed_cache_layout_matches_repro(mixed_pair):
    jmodel, _, model, _, cfg = mixed_pair
    want = jmodel.init_cache(2, 64)
    got = model.init_cache(2, 64, "cpu")
    assert set(got) == set(want)
    for key in ("k_global", "v_global", "k_local", "v_local"):
        assert tuple(got[key].shape) == tuple(want[key].shape)
    assert got["k_local"].shape[2] == cfg.window == 16
    assert transformer._lg_layout(cfg) == \
        jax_transformer._lg_layout(cfg).tolist()


def test_mixed_cache_has_no_prefill(mixed_pair):
    _, _, model, params, _ = mixed_pair
    with pytest.raises(ValueError, match="mixed_cache has no prefill"):
        model.prefill(params, {"tokens": torch.zeros((1, 8),
                                                     dtype=torch.long)},
                      max_seq=64)


def test_mixed_decode_matches_repro_and_the_full_cache_past_a_wrap(
        mixed_pair):
    """40 steps from token 0 on a ring of 16 slots (it wraps twice): the
    logits equal ``repro``'s ``decoder_decode_mixed`` step by step, and the
    full-cache decode's fed the same tokens (a local layer's window of 16
    is exactly what its ring holds)."""
    jmodel, jparams, model, params, cfg = mixed_pair
    full = build(dataclasses.replace(cfg, mixed_cache=False))
    jcache = jmodel.init_cache(2, 64)
    mixed = model.init_cache(2, 64, "cpu")
    dense = full.init_cache(2, 64, "cpu")
    jdecode = jax.jit(jmodel.decode)
    tok = np.array([[3], [5]])
    for step in range(40):
        jl, jcache = jdecode(jparams, jnp.asarray(tok, jnp.int32), jcache)
        tl, mixed = model.decode(params, torch.from_numpy(tok.copy()), mixed)
        fl, dense = full.decode(params, torch.from_numpy(tok.copy()), dense)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tl.numpy(), fl.numpy(), **TOL)
        tok = np.asarray(jnp.argmax(jl, -1))[:, None]
    assert mixed["pos"].tolist() == [40, 40]
    np.testing.assert_allclose(mixed["k_local"].numpy(),
                               np.asarray(jcache["k_local"]), **TOL)
