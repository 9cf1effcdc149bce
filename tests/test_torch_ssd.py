"""The port's SSD scan (src/repro_torch/kernels) against the JAX package's.

On the CPU the port computes the scan with its plain version,
``ref.ssd_reference``, chosen by ``ops.ssd`` only because the tensors lie on
the CPU; the CUDA kernel (``ssd_scan.ssd_cuda``) refuses CPU tensors. The
plain version is held against ``repro``'s Pallas kernel in interpret mode
and against ``repro``'s oracle on ``test_ssd_sweep``'s shapes and dtypes,
with and without an initial state. Inputs are made with numpy from a seed
and given to both packages.

Tolerances are ``tests/test_kernels.py::test_ssd_sweep``'s: atol 1e-4,
rtol 1e-3 in float32 (the same sums in another order: the einsums contract
in another order and the cumulative sums are taken differently), 1e-1 in
bf16 (every chunk-local product rounds to bf16 in both packages, at other
places).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.ssd_scan import ssd_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_cuda

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(dtype):
    return dict(atol=1e-1, rtol=1e-1) if dtype == "bfloat16" \
        else dict(atol=1e-4, rtol=1e-3)


def _inputs(seed, b, l, h, p, n, with_state=False):
    """x, dt > 0 (softplus), A < 0, B, C, optional state; float32 numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = (rng.standard_normal((b, l, h, p)) * 0.5).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(f32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(f32)
    B = (rng.standard_normal((b, l, n)) * 0.5).astype(f32)
    C = (rng.standard_normal((b, l, n)) * 0.5).astype(f32)
    arrs = [x, dt, A, B, C]
    if with_state:
        arrs.append((rng.standard_normal((b, h, p, n)) * 0.5).astype(f32))
    return arrs


def _both(arrs, dtype):
    tdt, jdt = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a).astype(jdt) for a in arrs])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,p,n,chunk", [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 4, 32, 16, 32),
    (1, 256, 8, 64, 128, 128),     # production-like head
])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_reference_matches_pallas_and_oracle(dtype, b, l, h, p, n, chunk,
                                                 with_state):
    arrs = _inputs(l + n + with_state, b, l, h, p, n, with_state)
    t, j = _both(arrs, dtype)
    init_t = t[5] if with_state else None
    init_j = j[5] if with_state else None
    y, fin = ref.ssd_reference(*t[:5], chunk=chunk, initial_state=init_t)
    assert y.dtype == fin.dtype == DTYPES[dtype][0]
    assert y.shape == (b, l, h, p) and fin.shape == (b, h, p, n)
    yp, finp = ssd_pallas(*j[:5], chunk=chunk, initial_state=init_j,
                          interpret=True)
    yr, finr = jax_ref.ssd_reference(*j[:5], chunk=chunk,
                                     initial_state=init_j)
    for want_y, want_fin in ((yp, finp), (yr, finr)):
        _close(y, want_y, dtype)
        _close(fin, want_fin, dtype)


def test_ssd_decode_reference_matches_reference():
    """One recurrent step, float32: 1e-6 (one multiply-add per element and
    an n-term sum)."""
    b, h, p, n = 3, 4, 8, 16
    x, dt, A, B, C, S = _inputs(7, b, 1, h, p, n, with_state=True)
    args = [x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], S]
    y, state = ref.ssd_decode_reference(*[torch.from_numpy(a) for a in args])
    yj, statej = jax_ref.ssd_decode_reference(*[jnp.asarray(a) for a in args])
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(state.numpy(), np.asarray(statej), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_equals_decode_loop(with_state):
    """Property: the chunked scan equals the step-by-step recurrence
    (float32, 1e-4/1e-3 as in ``repro``'s test of the same property)."""
    b, l, h, p, n = 2, 32, 2, 8, 4
    x, dt, A, B, C, *rest = [torch.from_numpy(a) for a in
                             _inputs(3, b, l, h, p, n, with_state)]
    state = rest[0] if with_state else torch.zeros((b, h, p, n))
    y, fin = ref.ssd_reference(x, dt, A, B, C, chunk=8,
                               initial_state=rest[0] if with_state else None)
    outs = []
    for t in range(l):
        yt, state = ref.ssd_decode_reference(x[:, t], dt[:, t], A, B[:, t],
                                             C[:, t], state)
        outs.append(yt)
    torch.testing.assert_close(y, torch.stack(outs, 1), atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(fin, state, atol=1e-4, rtol=1e-3)


def test_ssd_reference_has_no_nan_from_the_upper_triangle():
    """Steep decays (cs falls by ~1e3 over a chunk) would make exp of the
    upper triangle overflow; the plain version never forms it."""
    x, dt, A, B, C = [torch.from_numpy(a) for a in
                      _inputs(9, 1, 32, 2, 4, 4)]
    y, fin = ref.ssd_reference(x, dt * 50.0, A * 20.0, B, C, chunk=32)
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()


def test_ops_ssd_routes_cpu_tensors_to_the_plain_version(monkeypatch):
    x, dt, A, B, C = [torch.from_numpy(a) for a in
                      _inputs(4, 1, 32, 2, 8, 8)]
    calls = []
    plain = ref.ssd_reference
    monkeypatch.setattr(ref, "ssd_reference",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    launches = ssd_cuda.launches
    y, fin = ops.ssd(x, dt, A, B, C, chunk=16)
    assert calls == [1] and ssd_cuda.launches == launches
    want = plain(x, dt, A, B, C, chunk=16)
    torch.testing.assert_close(y, want[0], rtol=0, atol=0)
    torch.testing.assert_close(fin, want[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="no implementation"):
        ops.ssd(x.to("meta"), dt, A, B, C, chunk=16)


def test_ssd_kernel_refuses_cpu_tensors():
    x, dt, A, B, C = [torch.from_numpy(a) for a in
                      _inputs(5, 1, 32, 2, 8, 8)]
    launches = ssd_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_cuda(x, dt, A, B, C, chunk=16)
    assert ssd_cuda.launches == launches
