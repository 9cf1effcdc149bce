"""The port's gemma3-1b decoder (src/repro_torch/models) against the JAX
package's, on the ``.smoke()`` config in float32 (7 layers, layer 5
global, window 16, d_model 64, vocab 256).

Both packages compute with one set of weights: ``repro``'s
``Model.init(PRNGKey(0))``, handed to the port through
``params_from_numpy``. Inputs are made with numpy from a seed.

Tolerance for logits: 1e-4 in float32. The two frameworks run the same
float32 arithmetic with other summation orders in every matmul, norm and
softmax, over 7 layers and up to 8 decode steps; the observed gap is about
1e-6 on logits of magnitude ~0.5, so 1e-4 leaves room without hiding a
wrong mask, window or position (those move logits by 1e-2 or more).
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
from repro_torch.models import ModelConfig, build, layers
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jax_get("gemma3-1b").smoke(), dtype="float32")
    cfg = dataclasses.replace(get("gemma3-1b").smoke(), dtype="float32")
    jmodel = jax_build(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, build(cfg), params, cfg


def test_config_copy_matches_reference():
    """The port's copy of the config equals the JAX package's, field by
    field, at full width and cut to smoke size."""
    for make in (lambda c: c, lambda c: c.smoke()):
        assert dataclasses.asdict(make(get("gemma3-1b"))) == \
            dataclasses.asdict(make(jax_get("gemma3-1b")))
    cfg = get("gemma3-1b")
    assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (26, 1152, 262144)
    assert cfg.n_params() == jax_get("gemma3-1b").n_params()


def test_layer_windows_match_reference():
    for cfg, jcfg in ((get("gemma3-1b"), jax_get("gemma3-1b")),
                      (get("gemma3-1b").smoke(), jax_get("gemma3-1b").smoke())):
        want = [None if w == jax_transformer.BIG_WINDOW else int(w)
                for w in np.asarray(jax_transformer._layer_windows(jcfg))]
        assert transformer._layer_windows(cfg) == want
    full = transformer._layer_windows(get("gemma3-1b"))
    assert [i for i, w in enumerate(full) if w is None] == [5, 11, 17, 23]


def test_params_from_numpy_layouts(pair):
    jmodel, jparams, _, params, cfg = pair
    np.testing.assert_array_equal(params["embed"].numpy(),
                                  np.asarray(jparams["embed"]))
    assert len(params["layers"]) == cfg.n_layers
    for i in (0, cfg.n_layers - 1):
        jl, tl = jparams["layers"], params["layers"][i]
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                tl["attn"][name]["w"].numpy(),
                np.asarray(jl["attn"][name]["w"][i]).T)
        for name in ("up", "gate", "down"):
            np.testing.assert_array_equal(
                tl["ffn"][name]["w"].numpy(),
                np.asarray(jl["ffn"][name]["w"][i]).T)
        np.testing.assert_array_equal(tl["attn"]["q_norm"]["scale"].numpy(),
                                      np.asarray(jl["attn"]["q_norm"]["scale"][i]))
        np.testing.assert_array_equal(tl["ln2"]["scale"].numpy(),
                                      np.asarray(jl["ln2"]["scale"][i]))
    assert "head" not in params            # tied embeddings


def test_norm_rope_mlp_match_reference(pair):
    _, jparams, _, params, cfg = pair
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    scale = rng.standard_normal(cfg.d_model).astype(np.float32)
    np.testing.assert_allclose(
        layers.norm({"scale": torch.from_numpy(scale)},
                    torch.from_numpy(x)).numpy(),
        np.asarray(jax_layers.norm({"scale": jnp.asarray(scale)},
                                   jnp.asarray(x))), **TOL)
    xr = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 1, 5))
    np.testing.assert_allclose(
        layers.rope(torch.from_numpy(xr), torch.from_numpy(pos),
                    cfg.rope_theta).numpy(),
        np.asarray(jax_layers.rope(jnp.asarray(xr), jnp.asarray(pos),
                                   cfg.rope_theta)), **TOL)
    jl = jax.tree.map(lambda a: a[2], jparams["layers"])
    np.testing.assert_allclose(
        layers.mlp(params["layers"][2]["ffn"], torch.from_numpy(x),
                   cfg).numpy(),
        np.asarray(jax_layers.mlp(jl["ffn"], jnp.asarray(x), cfg)), **TOL)


@pytest.mark.parametrize("window", [None, 4])
def test_prefill_attention_matches_reference(pair, window):
    """Self-attention over a prompt (the flash-kernel path of the port)
    against the JAX layer with the same window."""
    _, jparams, _, params, cfg = pair
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11), (2, 11))
    jl = jax.tree.map(lambda a: a[0], jparams["layers"])
    want, (jk, jv) = jax_layers.attention(
        jl["attn"], jnp.asarray(x), cfg, positions=jnp.asarray(pos),
        window=window)
    rot = layers.rope_angles(torch.from_numpy(pos.copy()), cfg.d_head,
                             cfg.rope_theta)
    got, (k, v) = layers.attention(
        params["layers"][0]["attn"], torch.from_numpy(x), cfg, rot=rot,
        window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


def test_forward_logits_match_reference(pair):
    jmodel, jparams, _, params, cfg = pair
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 24))
    want, _, _ = jax_transformer.decoder_forward(jparams, jmodel.cfg,
                                                 jnp.asarray(toks, jnp.int32))
    got, aux, _ = transformer.decoder_forward(params, cfg,
                                              torch.from_numpy(toks))
    assert aux == 0.0                        # a dense FFN has no aux loss
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,pad_to", [(40, None), (27, 32)])
def test_prefill_and_decode_match_reference(pair, S, pad_to):
    """Prefill logits and 8 greedy decode steps, prompt longer than the
    16-token window; with ``pad_to`` the prompt is right-padded to a bucket
    and prefilled with its true length, as the engine does."""
    jmodel, jparams, model, params, cfg = pair
    rng = np.random.default_rng(S)
    toks = rng.integers(0, cfg.vocab, (2, S))
    length = None
    if pad_to:
        toks = np.concatenate([toks, np.zeros((2, pad_to - S), toks.dtype)], 1)
        length = S
    jprefill = jax.jit(jmodel.prefill, static_argnames=("max_seq",))
    jdecode = jax.jit(jmodel.decode)
    jl, jc = jprefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                      max_seq=64,
                      length=None if length is None else jnp.int32(S))
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           max_seq=64, length=length)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["pos"].tolist() == [S, S]
    for _ in range(8):
        nxt = np.asarray(jnp.argmax(jl, -1))
        assert nxt.tolist() == torch.argmax(tl, -1).tolist()
        jl, jc = jdecode(jparams, jnp.asarray(nxt[:, None], jnp.int32), jc)
        tl, tc = model.decode(params, torch.from_numpy(nxt[:, None].copy()),
                              tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["pos"].tolist() == [S + 8, S + 8]


def test_other_families_name_their_roadmap_item():
    """MoE builds (and takes padded prompts, as in ``repro``); the
    encoder-decoder (whisper) names its ROADMAP item; an unknown arch
    names the known ones."""
    cfg = ModelConfig(name="tiny-moe", family="moe", n_layers=2, d_model=8,
                      n_heads=2, n_kv_heads=1, d_head=4, d_ff=8, vocab=16,
                      n_experts=2, top_k=1)
    assert build(cfg).supports_padded_prefill
    assert build(get("qwen3-32b")).cfg.family == "dense"
    with pytest.raises(NotImplementedError, match="ROADMAP.*13a.*whisper"):
        build(get("whisper-large-v3"))
    with pytest.raises(KeyError, match="gemma3-1b"):
        get("gemma4-1b")


def test_init_is_seeded_and_on_the_generator_device():
    cfg = dataclasses.replace(get("gemma3-1b").smoke(), dtype="float32")
    a = build(cfg).init(torch.Generator("cpu").manual_seed(5))
    b = build(cfg).init(torch.Generator("cpu").manual_seed(5))
    torch.testing.assert_close(a["embed"], b["embed"], rtol=0, atol=0)
    w = a["layers"][0]["attn"]["wq"]["w"]
    assert w.shape == (cfg.n_heads * cfg.d_head, cfg.d_model)
    assert w.device.type == "cpu" and w.dtype == torch.float32


def test_ssm_family_builds_and_hybrid_names_its_roadmap_item():
    """The port runs the dense, MoE and ssm programs; the hybrid (jamba)
    names its ROADMAP item. The registry holds ``repro``'s ten configs."""
    from repro.configs import ARCHS as JAX_ARCHS
    from repro_torch.configs import ARCHS
    assert list(ARCHS) == list(JAX_ARCHS) and len(ARCHS) == 10
    with pytest.raises(NotImplementedError, match="ROADMAP.*13b.*jamba"):
        build(get("jamba-1.5-large-398b"))
    assert build(get("mamba2-370m")).cfg.family == "ssm"
    assert build(get("gemma3-1b")).supports_padded_prefill
    assert not build(get("mamba2-370m")).supports_padded_prefill
    cfg = ModelConfig(name="tiny-hybrid", family="hybrid", n_layers=2,
                      d_model=8, n_heads=2, n_kv_heads=1, d_head=4, d_ff=8,
                      vocab=16, ssm_state=4, attn_period=2, n_experts=2,
                      top_k=1, moe_every=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.*13b.*hybrid"):
        build(cfg)
