"""The port's teacher-forced loss and its gradient against the JAX
package's, on the CPU in float32, and attention's backward (the plain
version the card's kernel is held to) against ``repro``'s hand-written
``_ca_bwd``.

* ``Model.loss`` and every gradient leaf for the ``.smoke()`` cut of each
  family: gemma3 (its 5:1 local:global period, window 16 under a 32-token
  prompt), qwen2-moe (with its load-balancing aux), mamba2, jamba (one
  period) and whisper (64 frames, 8 decoder tokens). ``repro``'s weights
  (biases and norm scales perturbed, so that a left-out term would show)
  and its gradients come across through ``params_from_numpy``.
  Tolerance: the loss within 1e-5, each gradient leaf within 1e-4 of its
  largest entry or 1e-8, whichever is larger (the same float32 arithmetic
  in another summation order; the floor is for leaves whose gradient is 0
  but for rounding, such as whisper's key bias, which the softmax
  ignores).
* ``flash_attention_backward_reference`` against ``jax.vjp`` of
  ``repro``'s ``chunked_attention`` at S = T = 2048 with a tiny head (past
  ``CHUNKED_THRESHOLD``, so ``_ca_bwd`` runs), causal, windowed and not
  causal, and ``flash_attention_lse_reference`` against the lse that
  ``_ca_bwd`` reads: within 1e-4 of each gradient's largest entry, 1e-5
  on lse.
* The backward reference against autograd through the plain forward at
  ragged, right-aligned and grouped shapes: within 1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.kernels.ref import _ca_fwd_impl, chunked_attention
from repro.models import build as jax_build
from repro.models.layers import CHUNKED_THRESHOLD
from repro_torch.configs import get
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash_attention import (
    flash_attention_backward_cuda, flash_attention_cuda)
from repro_torch.models import build
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.tree import leaves

torch.set_num_threads(1)
ARCHS = ("gemma3-1b", "qwen2-moe-a2.7b", "mamba2-370m",
         "jamba-1.5-large-398b", "whisper-large-v3")
GRAD_REL = 1e-4


def _perturbed(tree, rng):
    """``tree`` with every bias drawn from N(0, 0.1) and every norm scale
    from 1 + N(0, 0.1): ``repro`` initialises them to 0 and 1."""
    if isinstance(tree, dict):
        return {k: (0.1 * rng.normal(size=v.shape)).astype(v.dtype)
                if k in ("b", "bias") and not isinstance(v, dict)
                else (1 + 0.1 * rng.normal(size=v.shape)).astype(v.dtype)
                if k == "scale" and not isinstance(v, dict)
                else _perturbed(v, rng) for k, v in tree.items()}
    return np.asarray(tree)


def _batch(cfg, seed, B=2, S=32):
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        T, S = 64, 64 // 8
        b = {"frames": rng.normal(size=(B, T, cfg.d_model)).astype(
            np.float32)}
    else:
        b = {}
    b["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    b["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return b


def _port_value_and_grad(model, params, batch):
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss, metrics = model.loss(params, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    grads = torch.autograd.grad(loss, ps)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_repro(arch):
    jcfg = jax_get(arch).smoke()
    cfg = get(arch).smoke()
    jmodel = jax_build(jcfg)
    tree = _perturbed(jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0))), np.random.default_rng(1))
    batch = _batch(cfg, seed=3)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jax.tree.map(jnp.asarray, tree),
                                    jax.tree.map(jnp.asarray, batch))

    params = params_from_numpy(cfg, tree)
    loss, met, grads = _port_value_and_grad(build(cfg), params, batch)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    assert abs(float(met["ce"]) - float(jmet["ce"])) <= 1e-5
    assert abs(float(met["aux"]) - float(jmet["aux"])) <= 1e-5
    if cfg.family in ("moe", "hybrid"):
        assert float(met["aux"]) > 0          # the aux term is exercised

    want = leaves(params_from_numpy(cfg, jax.tree.map(np.asarray, jgrads)))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        bar = max(GRAD_REL * float(w.abs().max()), 1e-8)
        assert float((g - w).abs().max()) <= bar


def _qkv(rng, B, H, KH, S, T, D):
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(B, KH, T, D)).astype(np.float32)
    v = rng.normal(size=(B, KH, T, D)).astype(np.float32)
    do = rng.normal(size=(B, H, S, D)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("causal,window", [(True, None), (True, 300),
                                           (False, None)])
def test_backward_reference_matches_repro_ca_bwd(causal, window):
    B, KH, G, S, D = 1, 1, 2, 2048, 8
    assert S * S >= CHUNKED_THRESHOLD          # the path repro trains on
    q, k, v, do = _qkv(np.random.default_rng(4), B, KH * G, KH, S, S, D)
    # repro's layout: q (B,S,KH,G,D), k/v (B,T,KH,D)
    jq = jnp.asarray(q.transpose(0, 2, 1, 3).reshape(B, S, KH, G, D))
    jk = jnp.asarray(k.transpose(0, 2, 1, 3))
    jv = jnp.asarray(v.transpose(0, 2, 1, 3))
    jdo = jnp.asarray(do.transpose(0, 2, 1, 3).reshape(B, S, KH, G, D))
    out, vjp = jax.vjp(lambda a, b, c: chunked_attention(
        a, b, c, causal, window), jq, jk, jv)
    jdq, jdk, jdv = vjp(jdo)
    w = jnp.float32(jnp.inf) if window is None else jnp.float32(window)
    _, jlse = _ca_fwd_impl(jq, jk, jv, w, causal, 512, 1024)

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    win = window or 0
    o = ref.flash_attention_reference(tq, tk, tv, causal=causal, window=win)
    lse = ref.flash_attention_lse_reference(tq, tk, causal=causal,
                                            window=win)
    np.testing.assert_allclose(
        o.numpy(), np.asarray(out).reshape(B, S, KH * G, D).transpose(
            0, 2, 1, 3), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse).reshape(B, KH * G, S),
                               atol=1e-5)
    dq, dk, dv = ref.flash_attention_backward_reference(
        tq, tk, tv, o, lse, tdo, causal=causal, window=win)
    for got, want in ((dq, np.asarray(jdq).reshape(B, S, KH * G, D)
                       .transpose(0, 2, 1, 3)),
                      (dk, np.asarray(jdk).transpose(0, 2, 1, 3)),
                      (dv, np.asarray(jdv).transpose(0, 2, 1, 3))):
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= GRAD_REL * scale


@pytest.mark.parametrize("B,H,KH,S,T,D,causal,window", [
    (1, 4, 1, 40, 40, 16, True, 0),
    (2, 4, 2, 37, 53, 8, True, 9),        # right-aligned, ragged, GQA
    (1, 2, 1, 11, 29, 12, False, 0),      # not causal, S < T
    (1, 6, 3, 24, 24, 4, False, 5),       # a window without the causal mask
])
def test_backward_reference_matches_autograd(B, H, KH, S, T, D, causal,
                                             window):
    q, k, v, do = map(torch.from_numpy, _qkv(np.random.default_rng(S + T),
                                             B, H, KH, S, T, D))
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(o, (q, k, v), do)
    lse = ref.flash_attention_lse_reference(q.detach(), k.detach(),
                                            causal=causal, window=window)
    got = ref.flash_attention_backward_reference(
        q.detach(), k.detach(), v.detach(), o.detach(), lse, do,
        causal=causal, window=window)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_attention_kernels_take_cuda_tensors_only():
    q = torch.zeros((1, 2, 4, 8))
    k = torch.zeros((1, 1, 4, 8))
    lse = torch.zeros((1, 2, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, k, k, return_lse=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_backward_cuda(q, k, k, q, lse, q)


def test_refuse_autograd_names_the_reason():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="ROADMAP item 27"):
        _build.refuse_autograd("ssd", "see ROADMAP item 27", x)
    with torch.no_grad():
        _build.refuse_autograd("ssd", "see ROADMAP item 27", x)
    _build.refuse_autograd("ssd", "see ROADMAP item 27", x.detach())


def test_loss_is_float32_for_a_bf16_model():
    cfg = dataclasses.replace(get("gemma3-1b").smoke(), dtype="bfloat16")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 5).items()}
    loss, met = model.loss(params, batch)
    assert loss.dtype == met["ce"].dtype == met["aux"].dtype == torch.float32
    assert torch.isfinite(loss)
    assert abs(float(loss) - float(met["ce"])) == 0.0    # no aux (dense)
