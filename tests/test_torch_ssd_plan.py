"""The partition of the SSD backward's chunk kernels, and the kernel's
algebra, computed with no card.

``kernels/ssd_scan.py::backward_plan`` splits each (row, chunk)'s heads
into groups of g, one CTA a group, and the CTAs into thread-block clusters
that sum dB and dC in distributed shared memory
(``csrc/ssd_scan_backward.cu``). Checked here, on the H100's capacity
(the CTAs it runs at once by cluster size, from the occupancy API):

* coverage: every (row, chunk, head) falls to exactly one CTA, clusters
  hold at most 8 CTAs and groups at most 8 heads, and at mamba2-370m's
  and jamba's shapes every wave of CTAs nearly fills the SMs its cluster
  size reaches;
* order: the dB/dC sums run over a cluster's ranks in order, then over the
  clusters in order, which visits the heads in order;
* semantics: the gradient computed on the CPU the way the kernel computes
  it (C B^T once a (row, chunk), M summed over a CTA's heads, M B and M^T
  C once a CTA, the off-diagonal dC and the local dB as products over the
  CTA's heads, cluster and cluster-partial sums in the kernel's order)
  against the plain backward (``ref.ssd_backward_reference``; 1e-5 of
  each gradient's largest entry: the same float32 sums in another order)
  and ``jax.vjp`` of ``repro``'s ``ssd_reference`` (1e-4), on
  ``test_torch_ssd_backward.py``'s cases and on many heads at a small l
  (more than 8 groups: cluster partials) with h not divisible by g.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import ref
from repro_torch.kernels.ssd_scan import (FIXED_HEADS, MAX_CLUSTER,
                                          MAX_GROUP, BackwardPlan,
                                          backward_plan)
from test_torch_ssd_backward import CASES, NAMES, _inputs

torch.set_num_threads(1)

# The H100 SXM's CTAs of the chunk kernels at once, by cluster size (one
# CTA an SM; clusters of 3 or more reach 102 to 120 of its 132 SMs), as
# the occupancy API gave them on one (chip_smoke.py, "capacity")
H100 = {1: 132, 2: 132, 3: 117, 4: 120, 5: 110, 6: 102, 7: 105, 8: 120}

# mamba2-370m's training shape; jamba's 256 heads at l = 384 and 1,024;
# two rows of 512; one chunk (chip_smoke.py's "ssd_backward_kernels")
CHIP = [(4, 1024, 32, 128), (1, 384, 256, 128), (1, 1024, 256, 128),
        (2, 512, 32, 128), (1, 64, 32, 64)]
# a rank's local shapes on a mesh of several cards (the heads over
# "model", the rows over "data"): mamba2's 32 heads on (2, 2) and (1, 4),
# jamba's 256 on a "model" axis of 2 and 4 (chip_smoke.py's
# MESH_SSD_SHAPES)
MESH_LOCAL = [(2, 1024, 16, 128), (4, 1024, 8, 128), (1, 1024, 128, 128),
              (1, 1024, 64, 128)]


def _every_plan(b, l, h, ck):
    pairs = b * (l // ck)
    for g in range(1, min(h, MAX_GROUP) + 1):
        for cl in range(1, min(-(-h // g), MAX_CLUSTER) + 1):
            yield BackwardPlan.of(pairs, h, g, cl)


@pytest.mark.parametrize("b,l,h,ck", CHIP + MESH_LOCAL
                         + [(1, 32, 20, 16), (2, 64, 7, 16)])
def test_plan_covers_every_head_once(b, l, h, ck):
    for plan in [backward_plan(b, l, h, ck, H100)] + \
            list(_every_plan(b, l, h, ck)):
        assert 1 <= plan.cluster <= MAX_CLUSTER
        assert 1 <= plan.group <= MAX_GROUP
        heads = [hh for x in range(plan.clusters * plan.cluster)
                 for hh in plan.heads(x, h)]
        assert heads == list(range(h)), plan
        assert plan.ctas == b * (l // ck) * plan.clusters * plan.cluster


@pytest.mark.parametrize("b,l,h,ck", CHIP[:4])
def test_plan_fills_its_waves(b, l, h, ck):
    """At mamba2's and jamba's shapes the CTAs come in waves of nearly
    as many as the card runs at once (>= 95% of the SMs the cluster size
    reaches), and no other partition ends sooner by the plan's measure."""
    plan = backward_plan(b, l, h, ck, H100)
    waves = -(-plan.ctas // H100[plan.cluster])
    assert plan.ctas >= 0.95 * waves * H100[plan.cluster], plan

    def cost(p):
        return -(-p.ctas // H100[p.cluster]) * (FIXED_HEADS + p.group)
    assert all(cost(plan) <= cost(p) for p in _every_plan(b, l, h, ck))


def test_plan_at_mamba2_and_jamba():
    """The partitions the H100 runs: mamba2's 32 heads in 4 CTAs of 8
    heads, clusters of 2 (two dB/dC partials a (row, chunk), none per
    head); jamba's 256 heads in 6 or 8 a CTA."""
    assert backward_plan(4, 1024, 32, 128, H100) == BackwardPlan(8, 2, 2,
                                                                 128)
    assert backward_plan(1, 384, 256, 128, H100) == BackwardPlan(6, 2, 22,
                                                                 132)
    assert backward_plan(1, 1024, 256, 128, H100) == BackwardPlan(8, 2, 16,
                                                                  256)
    assert backward_plan(1, 64, 32, 64, H100) == BackwardPlan(1, 8, 4, 32)


@pytest.mark.parametrize("h,g,cl", [(32, 8, 2), (36, 5, 2), (20, 1, 8),
                                    (7, 3, 2)])
def test_sum_order_is_fixed_and_visits_heads_in_order(h, g, cl):
    plan = BackwardPlan.of(1, h, g, cl)
    order = plan.sum_order()
    assert order == sorted(order)
    assert [x for *_, x in order] == list(range(plan.clusters * cl))
    assert all(x == k * cl + r for k, r, x in order)
    seen = [hh for *_, x in order for hh in plan.heads(x, h)]
    assert seen == list(range(h))


def _kernel_backward(x, dt, A, B, C, dy, dfinal, init, chunk, plan):
    """The gradient as the kernel computes it, float32, pass by pass."""
    b, l, h, p = x.shape
    n, ck = B.shape[-1], chunk
    nc = l // ck
    tril = torch.tril(torch.ones(ck, ck, dtype=torch.bool))
    cs = ref._cumsum((dt * A).reshape(b, nc, ck, h).permute(0, 3, 1, 2))
    xd = x * dt[..., None]
    last = cs[..., -1]                                        # (b,h,nc)
    w = torch.exp(last[..., None] - cs)                       # (b,h,nc,ck)
    # the states entering the chunks, as the forward passes them
    carry = torch.zeros(b, h, p, n) if init is None else init.clone()
    prev = torch.zeros(b, nc, h, p, n)
    for c in range(nc):
        prev[:, c] = carry
        rows = slice(c * ck, (c + 1) * ck)
        local = torch.einsum("bzn,bhz,bzhp->bhpn", B[:, rows], w[:, :, c],
                             xd[:, rows])
        carry = carry * torch.exp(last[:, :, c])[..., None, None] + local
    dxd, dcs = torch.zeros(b, l, h, p), torch.zeros(b, h, nc, ck)
    dprev = torch.zeros(b, nc, h, p, n)
    dC, dbd = torch.zeros(plan.clusters, b, l, n), \
        torch.zeros(plan.clusters, b, l, n)
    ctas = plan.sum_order()
    # (a): C B^T once a (row, chunk); per CTA pass 4 over its heads, M B
    # and M^T C once, pass 1 over its heads; the cluster's sums in order
    for bi, c in itertools.product(range(b), range(nc)):
        rows = slice(c * ck, (c + 1) * ck)
        Cc, Bc = C[bi, rows], B[bi, rows]
        G = Cc @ Bc.T
        for k, r, xq in ctas:
            M = torch.zeros(ck, ck)
            for hh in plan.heads(xq, h):
                L = torch.exp(cs[bi, hh, c][:, None] - cs[bi, hh, c][None])
                L = L * tril
                P_, dyh = G * L, dy[bi, rows, hh]
                dxd[bi, rows, hh] = P_.T @ dyh
                DX = dyh @ xd[bi, rows, hh].T
                Q = P_ * DX
                dcs[bi, hh, c] = Q.sum(1) - Q.sum(0)
                M += DX * L
            dCx, dBx = M @ Bc, M.T @ Cc
            for hh in plan.heads(xq, h):
                ecs = torch.exp(cs[bi, hh, c])[:, None]
                dyh = dy[bi, rows, hh]
                dprev[bi, c, hh] = (ecs * dyh).T @ Cc
                o = ecs * (dyh @ prev[bi, c, hh])
                dCx += o
                dcs[bi, hh, c] += (o * Cc).sum(1)
            dC[k, bi, rows] += dCx
            dbd[k, bi, rows] += dBx
    # (b): the reverse state passing
    g = torch.zeros(b, h, p, n) if dfinal is None else dfinal.clone()
    dS, dlast = torch.zeros_like(dprev), torch.zeros(b, h, nc)
    for c in reversed(range(nc)):
        dS[:, c] = g
        E = torch.exp(last[:, :, c])
        dlast[:, :, c] = E * (g * prev[:, c]).sum((-2, -1))
        g = g * E[..., None, None] + dprev[:, c]
    dinit = g
    # (c): per CTA pass 3 over its heads (the local dB a product over them)
    # and pass 5; dB = the cluster's sum plus (a)'s share
    dx, ddt = torch.zeros(b, l, h, p), torch.zeros(b, l, h)
    dB, dap = torch.zeros(plan.clusters, b, l, n), torch.zeros(b, nc, h)
    for bi, c in itertools.product(range(b), range(nc)):
        rows = slice(c * ck, (c + 1) * ck)
        for k, r, xq in ctas:
            dBx = torch.zeros(ck, n)
            for hh in plan.heads(xq, h):
                wh, dth = w[bi, hh, c], dt[bi, rows, hh]
                gb = B[bi, rows] @ dS[bi, c, hh].T
                d = dxd[bi, rows, hh] + wh[:, None] * gb
                dx[bi, rows, hh] = d * dth[:, None]
                wdw = wh * dth * (x[bi, rows, hh] * gb).sum(1)
                dBx += (wh * dth)[:, None] * x[bi, rows, hh] @ dS[bi, c, hh]
                v = dcs[bi, hh, c] - wdw
                v[-1] += wdw.sum() + dlast[bi, hh, c]
                da = torch.flip(torch.cumsum(torch.flip(v, (0,)), 0), (0,))
                ddt[bi, rows, hh] = (d * x[bi, rows, hh]).sum(1) + A[hh] * da
                dap[bi, c, hh] = (dth * da).sum()
            dB[k, bi, rows] += dBx
        for k in range(plan.clusters):
            dB[k, bi, rows] += dbd[k, bi, rows]
    # (d): the clusters' partials and dA, in order
    return (dx, ddt, dap.sum((0, 1)), dB.sum(0), dC.sum(0), dinit)


def _close(got, want, bar, what):
    for name, a, w in zip(NAMES, got, want):
        a, w = np.asarray(a, np.float32), np.asarray(w, np.float32)
        assert a.shape == w.shape, (what, name)
        assert float(np.abs(a - w).max()) <= bar * float(np.abs(w).max()), \
            (what, name)


SEMANTICS = [c + (None,) for c in CASES] + [
    # 20 heads one a CTA: 3 clusters of 8 (4 CTAs empty), cluster partials
    (1, 32, 20, 4, 8, 16, True, True, (1, 8)),
    # 7 heads in groups of 3 (3, 3, 1) in clusters of 2: one CTA empty
    (2, 64, 7, 8, 16, 16, False, True, (3, 2)),
    (2, 64, 12, 8, 16, 32, True, False, (5, 2)),
]


@pytest.mark.parametrize("b,l,h,p,n,chunk,with_state,with_dfinal,forced",
                         SEMANTICS)
def test_kernel_algebra_matches_plain_and_jax(b, l, h, p, n, chunk,
                                              with_state, with_dfinal,
                                              forced):
    args, init, dy, dfinal = _inputs(7 * l + h, b, l, h, p, n)
    t = [torch.from_numpy(a) for a in args]
    init_t = torch.from_numpy(init) if with_state else None
    dfin_t = torch.from_numpy(dfinal) if with_dfinal else None
    pairs = b * (l // chunk)
    plans = [backward_plan(b, l, h, chunk, H100), BackwardPlan.of(
        pairs, h, 1, 1)]
    if forced is not None:
        plans.append(BackwardPlan.of(pairs, h, *forced))
    want = ref.ssd_backward_reference(*t, torch.from_numpy(dy), dfin_t,
                                      chunk=chunk, initial_state=init_t)
    want = [w.numpy() for w in want]

    def scan(x, dt, A, B, C, s):
        return jax_ref.ssd_reference(x, dt, A, B, C, chunk=chunk,
                                     initial_state=s)
    init_j = init if with_state else np.zeros_like(init)
    dfin_j = dfinal if with_dfinal else np.zeros_like(dfinal)
    _, vjp = jax.vjp(scan, *[jnp.asarray(a) for a in args],
                     jnp.asarray(init_j))
    jwant = vjp((jnp.asarray(dy), jnp.asarray(dfin_j)))
    for plan in plans:
        got = _kernel_backward(*t, torch.from_numpy(dy), dfin_t, init_t,
                               chunk, plan)
        got = [a.numpy() for a in got]
        _close(got, want, 1e-5, f"plain {plan}")
        _close(got, jwant, 1e-4, f"jax.vjp {plan}")
