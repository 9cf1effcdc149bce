"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA GPU (the kernels have no CPU mode, so every test here is marked
``cuda`` and skips without a card). Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX (the machine with the card has none). Shapes
include the serving path's (d_head 256, G = 4, a 2048-slot cache) and the
edges the kernels mask themselves: ragged S and T, right-aligned queries,
a head dimension that is no power of two, per-row ranges, a length past
the cache. Tolerances are those of ``tests/test_kernels.py::_tol``: 2e-5
in float32 (same sums, other order), 5e-2 in bf16 (inputs and outputs
rounded to bf16).
"""
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == torch.bfloat16 \
        else dict(atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KH,S,T,D,causal,window", [
    (1, 4, 1, 300, 300, 256, True, 512),   # ragged, window wider than S
    (2, 4, 2, 100, 100, 64, True, 16),
    (1, 8, 8, 64, 64, 16, False, 0),
    (1, 4, 1, 40, 97, 32, True, 24),       # right-aligned, ragged T
    (1, 2, 1, 129, 129, 200, False, 33),   # D not a power of two
])
def test_flash_kernel_matches_plain(cuda_device, dtype, B, H, KH, S, T, D,
                                    causal, window):
    g = torch.Generator(cuda_device).manual_seed(S + T + D)
    q = torch.randn((B, H, S, D), generator=g, device=cuda_device).to(dtype)
    k = torch.randn((B, KH, T, D), generator=g, device=cuda_device).to(dtype)
    v = torch.randn((B, KH, T, D), generator=g, device=cuda_device).to(dtype)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_reference(q, k, v, causal=causal,
                                         window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KH,S,D", [(4, 1, 2048, 256), (16, 2, 100, 64),
                                      (8, 8, 64, 16)])
def test_decode_kernel_matches_plain(cuda_device, dtype, H, KH, S, D):
    B = 4
    g = torch.Generator(cuda_device).manual_seed(S + D)
    q = torch.randn((B, H, D), generator=g, device=cuda_device).to(dtype)
    kc = torch.randn((B, S, KH, D), generator=g, device=cuda_device).to(dtype)
    vc = torch.randn((B, S, KH, D), generator=g, device=cuda_device).to(dtype)
    length = torch.tensor([1, S // 3, S, S + 5], dtype=torch.int32,
                          device=cuda_device)
    start = torch.tensor([0, max(S // 3 - 40, 0), S // 2, 0],
                         dtype=torch.int32, device=cuda_device)
    got = decode_attention_cuda(q, kc, vc, length, start)
    want = ref.decode_attention_reference(q, kc, vc, length, start)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
