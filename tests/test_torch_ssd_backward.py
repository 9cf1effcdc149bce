"""The SSD scan's backward in the port (src/repro_torch/kernels) against the
JAX package's gradient of the scan.

``repro`` has no hand-written SSD backward: it differentiates
``repro.kernels.ref.ssd_reference`` with ``jax.vjp``. The port's plain
backward, ``ref.ssd_backward_reference`` (the passes of the CUDA kernel
``csrc/ssd_scan_backward.cu``, written out as chunked tensor ops), is held
against that vjp and against torch autograd through the port's own
``ref.ssd_reference``, in float32, within 1e-4 of each gradient's largest
entry (the same sums in another order). On the CPU ``ops.ssd``
differentiates through the plain forward under ordinary autograd and never
reaches ``SSDScan``, whose kernels need a card. The wrapper's scratch plan
and work count are plain Python and are checked here. Inputs are made with
numpy from a seed and given to both packages.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import (SSDScan, backward_partials_bytes,
                                          backward_scratch, backward_work)

torch.set_num_threads(1)

NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinitial")


def _inputs(seed, b, l, h, p, n):
    """x, dt > 0 (softplus), A < 0, B, C, an initial state, and the
    cotangents dy and dfinal; float32 numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = (rng.standard_normal((b, l, h, p)) * 0.5).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(f32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(f32)
    B = (rng.standard_normal((b, l, n)) * 0.5).astype(f32)
    C = (rng.standard_normal((b, l, n)) * 0.5).astype(f32)
    init = (rng.standard_normal((b, h, p, n)) * 0.5).astype(f32)
    dy = rng.standard_normal((b, l, h, p)).astype(f32)
    dfinal = rng.standard_normal((b, h, p, n)).astype(f32)
    return [x, dt, A, B, C], init, dy, dfinal


def _assert_close(got, want, what):
    """Each gradient within 1e-4 of its largest entry."""
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, name)
        scale = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= 1e-4 * scale, (what, name)


SHAPES = [(1, 16, 2, 4, 8, 16),        # one chunk
          (2, 64, 3, 8, 16, 16)]       # four chunks, two rows
CASES = [s + (state, dfin) for s, state, dfin in
         itertools.product(SHAPES, (False, True), (False, True))]


@pytest.mark.parametrize("b,l,h,p,n,chunk,with_state,with_dfinal", CASES)
def test_plain_backward_matches_jax_vjp(b, l, h, p, n, chunk, with_state,
                                        with_dfinal):
    args, init, dy, dfinal = _inputs(l + h, b, l, h, p, n)
    init_j = init if with_state else np.zeros_like(init)
    dfin_j = dfinal if with_dfinal else np.zeros_like(dfinal)

    def scan(x, dt, A, B, C, s):
        return jax_ref.ssd_reference(x, dt, A, B, C, chunk=chunk,
                                     initial_state=s)
    _, vjp = jax.vjp(scan, *[jnp.asarray(a) for a in args],
                     jnp.asarray(init_j))
    want = vjp((jnp.asarray(dy), jnp.asarray(dfin_j)))
    got = ref.ssd_backward_reference(
        *[torch.from_numpy(a) for a in args], torch.from_numpy(dy),
        torch.from_numpy(dfinal) if with_dfinal else None, chunk=chunk,
        initial_state=torch.from_numpy(init) if with_state else None)
    _assert_close([t.numpy() for t in got], want, "jax.vjp")


@pytest.mark.parametrize("b,l,h,p,n,chunk,with_state,with_dfinal", CASES)
def test_plain_backward_matches_torch_autograd(b, l, h, p, n, chunk,
                                               with_state, with_dfinal):
    args, init, dy, dfinal = _inputs(3 * l + h, b, l, h, p, n)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in args + [init]]
    y, fin = ref.ssd_reference(*leaves[:5], chunk=chunk,
                               initial_state=leaves[5] if with_state
                               else None)
    outs, cts = [y], [torch.from_numpy(dy)]
    if with_dfinal:
        outs.append(fin)
        cts.append(torch.from_numpy(dfinal))
    want = torch.autograd.grad(outs, leaves[:5 + with_state], cts)
    got = ref.ssd_backward_reference(
        *[torch.from_numpy(a) for a in args], torch.from_numpy(dy),
        torch.from_numpy(dfinal) if with_dfinal else None, chunk=chunk,
        initial_state=torch.from_numpy(init) if with_state else None)
    _assert_close([t.numpy() for t in got[:len(want)]],
                  [t.numpy() for t in want], "autograd")


def test_plain_backward_keeps_dtypes_and_finite_in_bf16():
    """bf16 in, bf16 gradients out (dA in A's dtype, the initial state's in
    its own), finite over a 128-row chunk where cs reaches ~-100."""
    args, init, dy, dfinal = _inputs(5, 1, 256, 2, 8, 16)
    t = [torch.from_numpy(a).bfloat16() for a in args]
    got = ref.ssd_backward_reference(
        *t, torch.from_numpy(dy).bfloat16(),
        torch.from_numpy(dfinal).bfloat16(), chunk=128,
        initial_state=torch.from_numpy(init))
    assert [g.dtype for g in got] == [torch.bfloat16] * 5 + [torch.float32]
    assert all(bool(torch.isfinite(g).all()) for g in got)


def test_ops_ssd_differentiates_cpu_tensors_the_plain_way(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("SSDScan reached with CPU tensors")
    monkeypatch.setattr(SSDScan, "apply", refuse)
    args, init, dy, _ = _inputs(9, 1, 32, 2, 4, 8)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in args + [init]]
    y, _ = ops.ssd(*leaves[:5], chunk=16, initial_state=leaves[5])
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    want = ref.ssd_backward_reference(
        *[torch.from_numpy(a) for a in args], torch.from_numpy(dy), chunk=16,
        initial_state=torch.from_numpy(init))
    _assert_close([g.numpy() for g in got], [w.numpy() for w in want],
                  "ops.ssd")


def test_backward_scratch_plan():
    """The scratch of one call at mamba2-370m's training shape: no float32
    per-head partials of dB or dC; dB's diagonal share and dC's partial
    one a cluster of each (row, chunk) (two on the H100: 4 MiB each), dC's
    only where there is more than one cluster; as many <dS, prev>
    partials a (row, head, chunk) as the kernel says it has CTAs a (row,
    head) (32 of 256 threads at 64 x 128)."""
    b, l, h, p, n, ck = 4, 1024, 32, 64, 128, 128
    plan = backward_scratch(b, l, h, p, n, ck, 32, 2)
    assert list(plan) == ["ds", "dxd", "dcs", "dot", "dap", "dbd", "dcp"]
    assert plan["dbd"] == plan["dcp"] == (b, l, 2, n)
    assert 4 * np.prod(plan["dbd"]) == 4 << 20
    assert all(s[-2:] != (h, n) for s in plan.values())
    assert plan["ds"] == (b, l // ck, h, p, n)
    assert plan["dxd"] == (b, l, h, p)
    assert plan["dot"] == (b, h, l // ck, 32)
    assert plan["dap"] == (b, l // ck, h)
    one = backward_scratch(b, l, h, p, n, ck, 32, 1)
    assert list(one) == ["ds", "dxd", "dcs", "dot", "dap", "dbd"]
    assert one["dbd"] == (b, l, 1, n)
    assert backward_scratch(1, 20, 2, 24, 16, 20, 2, 1)["dot"] == (1, 2, 1, 2)


def test_backward_work_counts():
    """Flops: the products the function needs counted pair by pair on a
    small shape, C B^T, M B and M^T C once a (row, chunk) for all heads
    (M summed over them first: B and C do not depend on the head); bytes:
    inputs and gradients, with and without a final-state cotangent, and
    the kernel's dB/dC partials apart from them."""
    b, l, h, p, n, ck = 2, 48, 3, 5, 7, 16
    fma = 0
    for _ in range(b * (l // ck)):
        for i in range(ck):
            for j in range(i + 1):
                fma += 3 * n                        # C B^T, M B, M^T C
        for _ in range(h):
            fma += 4 * ck * p * n                   # the dense products
            for i in range(ck):
                for j in range(i + 1):
                    fma += 2 * p                    # dy xd^T, P^T dy
    nbytes, flops = backward_work(b, l, h, p, n, ck, 4)
    assert flops == 2 * fma
    xs, ss, nc = b * l * h * p, b * h * p * n, l // ck
    want = 4 * (2 * xs + b * l * h + h + 2 * b * l * n + nc * ss) \
        + 4 * b * h * l + 4 * (xs + b * l * h + h + 2 * b * l * n + ss)
    assert nbytes == want
    # dB's diagonal share written and read; with clusters, dC's partials
    # written and read and dB's read, written back and read
    assert backward_partials_bytes(b, l, n, 1) == 8 * b * l * n
    assert backward_partials_bytes(b, l, n, 4) == 6 * 4 * b * l * 4 * n
    assert backward_work(b, l, h, p, n, ck, 4, dfinal=True)[0] \
        == want + 4 * ss
    assert backward_work(b, l, h, p, n, ck, 2)[1] == flops
