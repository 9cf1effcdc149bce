"""The port's Mamba-2 stack (src/repro_torch/models/ssm.py and the ssm
program of models/transformer.py) against the JAX package's, on
``mamba2-370m.smoke()`` in float32 (2 layers, d_model 64, d_inner 128, 8
SSD heads of 16, state 16, chunk 16, conv 4, vocab 256).

Both packages compute with one set of weights: ``repro``'s
``Model.init(PRNGKey(0))``, handed to the port through
``params_from_numpy``. ``repro`` runs its prefill scan through the Pallas
kernel in interpret mode (``ssm_impl="pallas_interpret"``); the port runs
its plain version (CPU tensors). Inputs are made with numpy from a seed.
Prompt lengths 27 and 40 are no multiple of the 16-token chunk, so the
dt = 0 padding of the last chunk is exercised.

Tolerance for activations and logits: 1e-4 in float32. The same float32
arithmetic runs in another summation order in every matmul, norm, conv
and scan; the observed gap is ~1e-6, so 1e-4 leaves room without hiding a
wrong cast, pad, conv window or state carry (those move logits by 1e-2 or
more).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.models import build as jax_build
from repro.models import ssm as jax_ssm
from repro_torch.configs import get
from repro_torch.models import build, ssm
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(jax_get("mamba2-370m").smoke(), dtype=dtype,
                               ssm_impl="pallas_interpret")
    cfg = dataclasses.replace(get("mamba2-370m").smoke(), dtype=dtype)
    return jcfg, cfg


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = _cfgs()
    jmodel = jax_build(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, build(cfg), params, cfg


def _np(t):
    return t.detach().float().numpy()


def test_mamba2_config_copy_matches_reference():
    """The port's copy of the config equals the JAX package's, field by
    field, at full width and cut to smoke size."""
    for make in (lambda c: c, lambda c: c.smoke()):
        assert dataclasses.asdict(make(get("mamba2-370m"))) == \
            dataclasses.asdict(make(jax_get("mamba2-370m")))
    cfg = get("mamba2-370m")
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
            cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk, cfg.vocab) == \
        (48, 1024, 2048, 32, 64, 128, 128, 50280)
    assert cfg.n_params() == jax_get("mamba2-370m").n_params()


def test_params_from_numpy_ssm_tree():
    """Layouts of the ssm tree; under a bf16 config ``A_log`` and
    ``dt_bias`` stay float32 and every other leaf is bf16."""
    jcfg, cfg = _cfgs("bfloat16")
    jparams = jax.jit(jax_build(jcfg).init)(jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, jparams)
    params = params_from_numpy(cfg, tree)
    assert len(params["layers"]) == cfg.n_layers
    for i in (0, cfg.n_layers - 1):
        jm, tm = tree["layers"]["mamba"], params["layers"][i]["mamba"]
        for name in ("in_proj", "out_proj"):
            np.testing.assert_array_equal(
                _np(tm[name]["w"]), jm[name]["w"][i].astype(np.float32).T)
        np.testing.assert_array_equal(_np(tm["conv_w"]),
                                      jm["conv_w"][i].astype(np.float32))
        assert tm["conv_w"].shape == (cfg.ssm_conv,
                                      cfg.d_inner + 2 * cfg.ssm_state)
        for name in ("A_log", "dt_bias"):
            assert tm[name].dtype == torch.float32
            np.testing.assert_array_equal(tm[name].numpy(), jm[name][i])
        for name in ("conv_b", "D"):
            assert tm[name].dtype == torch.bfloat16
        assert tm["out_norm"]["scale"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            _np(params["layers"][i]["ln"]["scale"]),
            tree["layers"]["ln"]["scale"][i].astype(np.float32))
    np.testing.assert_array_equal(_np(params["head"]),
                                  tree["head"].astype(np.float32).T)
    assert params["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("L", [27, 40])
def test_mamba_block_prefill_and_decode_match_reference(pair, L):
    """One Mamba-2 block: prefill over L tokens, then 4 decode steps from
    its (conv, ssm) state, against ``repro``'s block."""
    jmodel, jparams, _, params, cfg = pair
    jp = jax.tree.map(lambda a: a[1], jparams["layers"])["mamba"]
    tp = params["layers"][1]["mamba"]
    rng = np.random.default_rng(L)
    x = rng.standard_normal((2, L, cfg.d_model)).astype(np.float32)
    want, (jconv, jstate) = jax_ssm.mamba_prefill(jp, jnp.asarray(x),
                                                  jmodel.cfg)
    got, (conv, state) = ssm.mamba_prefill(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(conv), np.asarray(jconv), **TOL)
    np.testing.assert_allclose(_np(state), np.asarray(jstate), **TOL)
    for step in range(4):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, (jconv, jstate) = jax_ssm.mamba_decode(
            jp, jnp.asarray(xt), jmodel.cfg, (jconv, jstate))
        got, (conv, state) = ssm.mamba_decode(tp, torch.from_numpy(xt), cfg,
                                              (conv, state))
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        np.testing.assert_allclose(_np(state), np.asarray(jstate), **TOL)


@pytest.mark.parametrize("S", [27, 40])
def test_prefill_and_decode_match_reference(pair, S):
    """The whole model: prefill logits and 4 greedy decode steps, with the
    cache's conv and ssm states, against ``repro``."""
    jmodel, jparams, model, params, cfg = pair
    toks = np.random.default_rng(S + 1).integers(0, cfg.vocab, (2, S))
    jprefill = jax.jit(jmodel.prefill, static_argnames=("max_seq",))
    jdecode = jax.jit(jmodel.decode)
    jl, jc = jprefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                      max_seq=64)
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           max_seq=64)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    assert tc["pos"].tolist() == [S, S]
    assert tc["conv"].shape == jc["conv"].shape
    assert tc["ssm"].shape == jc["ssm"].shape
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl, -1))
        assert nxt.tolist() == torch.argmax(tl, -1).tolist()
        jl, jc = jdecode(jparams, jnp.asarray(nxt[:, None], jnp.int32), jc)
        tl, tc = model.decode(params, torch.from_numpy(nxt[:, None].copy()),
                              tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(_np(tc["conv"]), np.asarray(jc["conv"]), **TOL)
    np.testing.assert_allclose(_np(tc["ssm"]), np.asarray(jc["ssm"]), **TOL)
    assert tc["pos"].tolist() == [S + 4, S + 4]


def test_forward_logits_match_reference(pair):
    """Teacher-forced logits at every position of a 40-token prompt."""
    from repro.models import transformer as jax_transformer
    from repro_torch.models import transformer
    jmodel, jparams, _, params, cfg = pair
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 40))
    want, _, _ = jax_transformer.ssm_forward(jparams, jmodel.cfg,
                                             jnp.asarray(toks, jnp.int32))
    got, states = transformer.ssm_forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert len(states) == cfg.n_layers


def test_short_prompt_is_refused(pair):
    """A prompt shorter than ssm_conv - 1 = 3 tokens cannot fill the conv
    state (``repro`` would cache a short one)."""
    _, _, model, params, cfg = pair
    with pytest.raises(ValueError, match="at least ssm_conv - 1 = 3"):
        model.prefill(params, {"tokens": torch.zeros((1, 2),
                                                     dtype=torch.long)},
                      max_seq=64)
    logits, cache = model.prefill(
        params, {"tokens": torch.zeros((1, 3), dtype=torch.long)},
        max_seq=64)
    assert cache["conv"].shape[2] == cfg.ssm_conv - 1


def test_recurrent_prefill_rejects_padded_prompts(pair):
    _, _, model, params, _ = pair
    assert not model.supports_padded_prefill
    with pytest.raises(ValueError, match="recurrent prefill"):
        model.prefill(params, {"tokens": torch.zeros((1, 8),
                                                     dtype=torch.long)},
                      max_seq=64, length=5)


def test_init_is_seeded_with_reference_dtypes():
    cfg = dataclasses.replace(get("mamba2-370m").smoke(), dtype="bfloat16")
    a = build(cfg).init(torch.Generator("cpu").manual_seed(3))
    b = build(cfg).init(torch.Generator("cpu").manual_seed(3))
    torch.testing.assert_close(a["embed"], b["embed"], rtol=0, atol=0)
    m = a["layers"][0]["mamba"]
    assert m["in_proj"]["w"].shape == (
        2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads, cfg.d_model)
    assert m["in_proj"]["w"].dtype == torch.bfloat16
    assert m["A_log"].dtype == m["dt_bias"].dtype == torch.float32
    assert a["head"].shape == (cfg.vocab, cfg.d_model)
