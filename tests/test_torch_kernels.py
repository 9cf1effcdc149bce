"""The port's attention kernels (src/repro_torch/kernels) against the JAX
package's.

On the CPU the port runs each kernel's plain PyTorch version; it is held
here against ``repro.kernels.ref`` and against the Pallas kernels in
interpret mode, on the shapes of ``tests/test_kernels.py`` plus per-row
ranges, at 2e-5 in float32 (the fp32 bar of ``test_kernels._tol``: both
sides compute the same float32 sums in another order).

The CUDA kernels themselves run only on a card: ``test_torch_cuda.py``
holds them against these plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 reset_launches)

torch.set_num_threads(1)
FP32 = dict(atol=2e-5, rtol=2e-5)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("B,H,KH,S,D,bq,bk", [
    (1, 2, 1, 128, 32, 64, 64),
    (2, 4, 2, 256, 64, 128, 128),
    (1, 8, 8, 64, 16, 32, 32),     # MHA
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_flash_plain_matches_jax(B, H, KH, S, D, bq, bk, causal, window):
    rng = np.random.default_rng(S + D + window)
    q, k, v = (_normal(rng, (B, H, S, D)), _normal(rng, (B, KH, S, D)),
               _normal(rng, (B, KH, S, D)))
    got = ref.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window).numpy()
    want = np.asarray(jref.flash_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=bq, block_k=bk, interpret=True))
    np.testing.assert_allclose(got, want, **FP32)
    np.testing.assert_allclose(got, pallas, **FP32)


def test_flash_plain_right_aligns_queries():
    """S < T: query i sits at position i + T - S (chunked prefill)."""
    rng = np.random.default_rng(7)
    q, k, v = (_normal(rng, (1, 4, 24, 16)), _normal(rng, (1, 2, 40, 16)),
               _normal(rng, (1, 2, 40, 16)))
    got = ref.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=8).numpy()
    want = np.asarray(jref.flash_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=8))
    np.testing.assert_allclose(got, want, **FP32)


@pytest.mark.parametrize("B,H,KH,S,D,bs", [
    (2, 8, 2, 512, 64, 128),
    (1, 4, 4, 256, 32, 64),
    (4, 16, 2, 128, 16, 128),
])
@pytest.mark.parametrize("length,start", [(100, 0), (512, 0), (200, 60)])
def test_decode_plain_matches_jax(B, H, KH, S, D, bs, length, start):
    length = min(length, S)
    rng = np.random.default_rng(S + length + start)
    q = _normal(rng, (B, H, D))
    kc, vc = _normal(rng, (B, S, KH, D)), _normal(rng, (B, S, KH, D))
    got = ref.decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        length, start).numpy()
    want = np.asarray(jref.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(length),
        jnp.int32(start)))
    pallas = np.asarray(decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(length),
        jnp.int32(start), block_s=bs, interpret=True))
    np.testing.assert_allclose(got, want, **FP32)
    np.testing.assert_allclose(got, pallas, **FP32)


def test_decode_plain_per_row_ranges():
    """One [start, length) per row, as the batched engine decodes: each row
    equals the JAX kernel run on that row alone with scalar bounds, including
    a length past the cache (an idle lane) and a local window."""
    B, H, KH, S, D = 4, 4, 1, 256, 32
    rng = np.random.default_rng(11)
    q = _normal(rng, (B, H, D))
    kc, vc = _normal(rng, (B, S, KH, D)), _normal(rng, (B, S, KH, D))
    length = np.array([1, 77, 256, 300], np.int32)
    start = np.maximum(length - np.array([0, 16, 64, 16]), 0).astype(np.int32)
    start[0] = 0
    got = ref.decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(length), torch.from_numpy(start)).numpy()
    for b in range(B):
        want = np.asarray(decode_attention_pallas(
            jnp.asarray(q[b:b + 1]), jnp.asarray(kc[b:b + 1]),
            jnp.asarray(vc[b:b + 1]), jnp.int32(length[b]),
            jnp.int32(start[b]), block_s=128, interpret=True))
        np.testing.assert_allclose(got[b:b + 1], want, **FP32)


def test_ops_route_cpu_tensors_to_plain_versions():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_normal(rng, (1, 2, 32, 16)))
    k = torch.from_numpy(_normal(rng, (1, 1, 32, 16)))
    v = torch.from_numpy(_normal(rng, (1, 1, 32, 16)))
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, causal=True, window=8),
        ref.flash_attention_reference(q, k, v, causal=True, window=8),
        rtol=0, atol=0)
    qd, kc = q[:, :, 0].contiguous(), k.transpose(1, 2).contiguous()
    vc = v.transpose(1, 2).contiguous()
    length = torch.tensor([20], dtype=torch.int32)
    start = torch.tensor([4], dtype=torch.int32)
    torch.testing.assert_close(
        ops.decode_attention(qd, kc, vc, length, start),
        ref.decode_attention_reference(qd, kc, vc, length, start),
        rtol=0, atol=0)


def test_ops_reject_devices_without_an_implementation():
    q = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        ops.flash_attention(q, q[:, :1], q[:, :1])


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers launch or raise; they never compute a CPU
    tensor on another path, and a refused call counts no launch."""
    before = (decode_attention_cuda.launches, flash_attention_cuda.launches)
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, q[:, :1].contiguous(), q[:, :1].contiguous())
    qd, kc = torch.zeros((1, 2, 16)), torch.zeros((1, 8, 1, 16))
    lens = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        decode_attention_cuda(qd, kc, kc, lens, lens)
    assert (decode_attention_cuda.launches,
            flash_attention_cuda.launches) == before


def test_flash_reset_launches_zeroes_every_count():
    """The total and the per-variant counts (bf16 wgmma kernel, float32
    split-TF32 kernel) start from 0 together, as chip_smoke.py needs."""
    saved = (flash_attention_cuda.launches,
             dict(flash_attention_cuda.variant_launches))
    try:
        flash_attention_cuda.launches = 3
        flash_attention_cuda.variant_launches.update(wgmma=2, tf32x3=1)
        reset_launches()
        assert flash_attention_cuda.launches == 0
        assert flash_attention_cuda.variant_launches == {
            "wgmma": 0, "tf32x3": 0}
    finally:
        flash_attention_cuda.launches = saved[0]
        flash_attention_cuda.variant_launches.update(saved[1])


@pytest.mark.parametrize("pairs,sms,want", [
    (4, 132, 16),     # gemma3-1b's 4 slots x 1 kv head on an H100
    (6, 132, 16),     # 96 CTAs
    (9, 132, 8),      # 16 would need 144 CTAs: more than one wave
    (32, 132, 4),
    (200, 132, 1),    # more pairs than SMs: no split
    (1, 8, 8),
])
def test_decode_cluster_size_fills_one_wave(pairs, sms, want):
    """The decode kernel's cluster: the largest power of two up to 16 whose
    grid (pairs x cluster CTAs, one an SM) fits the card's SMs."""
    from repro_torch.kernels.decode_attention import cluster_size
    assert cluster_size(pairs, sms) == want


def test_ptxas_usage_reads_registers_and_spills(tmp_path):
    """The build keeps nvcc's output beside each library; ``ptxas_usage``
    turns ptxas's lines into each kernel entry's registers and spills (what
    chip_smoke.py reports from its build)."""
    from repro_torch.kernels import _build
    (tmp_path / "libk.log").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z3twoPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3twoPf\n"
        "    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill "
        "loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z3onev' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 32 registers, used 0 barriers\n")
    assert _build.ptxas_usage(tmp_path) == {"k": [
        {"entry": "_Z3twoPf", "spill_store_bytes": 12, "spill_load_bytes": 8,
         "registers": 128},
        {"entry": "_Z3onev", "spill_store_bytes": 0, "spill_load_bytes": 0,
         "registers": 32}]}
