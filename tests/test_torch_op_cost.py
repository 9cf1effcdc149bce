"""The port's op cost model (``repro_torch/launch/op_cost.py``) against
``repro``'s HLO cost model (``repro/launch/hlo_cost.py``), the
counterparts of ``tests/test_hlo_cost.py``'s three tests, on the CPU:

* a loop of 8 ``tanh(x @ w[i])`` counts 8 x 2*64*128*128 matmul flops
  (the port's Python loop dispatches each trip), and ``repro``'s
  ``analyze`` of the scanned twin counts within 2% of that;
* value-and-grad of a 2-layer MLP: the port's matmul flops equal the dot
  flops of ``repro``'s ``top_costs`` of the same function, compiled;
* an aten op with several results (``native_layer_norm``: the output, the
  mean and the reciprocal deviation) has every result's bytes counted.

And the port's own: attention and the SSD scan on meta, differentiated,
are counted by their kernels' own work (``forward_work``,
``backward_work``) with their plain versions' ops kept apart, which
``totals(plain=True)`` counts as ordinary autograd of the plain version
does; ``mask_pairs`` counts what ``ref.attention_mask`` keeps; a gather
reads its source at the entries it picks.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch.hlo_cost import analyze as jax_analyze
from repro.launch.hlo_cost import top_costs as jax_top_costs
from repro_torch.kernels import flash_attention, ops, ref, ssd_scan
from repro_torch.launch import op_cost

torch.set_num_threads(1)
META = torch.device("meta")


def test_loop_trip_scaling():
    def f_loop(x, w):
        for i in range(8):
            x = torch.tanh(x @ w[i])
        return x

    x = torch.empty((64, 128), device=META)
    w = torch.empty((8, 128, 128), device=META)
    _, cost = op_cost.count(f_loop, x, w)
    dot_flops = 8 * 2 * 64 * 128 * 128
    assert cost.rows["aten.mm"].flops == dot_flops
    assert cost.rows["aten.mm"].calls == 8
    assert cost.totals()["flops"] == dot_flops
    assert cost.totals()["transcendentals"] == 8 * 64 * 128
    assert "aten.select" not in cost.rows           # views move nothing

    def f_scan(x, w):
        def body(c, wi):
            return jnp.tanh(c @ wi), None
        y, _ = jax.lax.scan(body, x, w)
        return y

    jx = jax.ShapeDtypeStruct((64, 128), jnp.float32)
    jw = jax.ShapeDtypeStruct((8, 128, 128), jnp.float32)
    a_scan = jax_analyze(jax.jit(f_scan).lower(jx, jw).compile().as_text())
    assert a_scan["flops"] == pytest.approx(dot_flops, rel=0.02)


def test_mlp_value_and_grad_matches_repro_dot_flops():
    def loss(a, b, x, y):
        h = torch.nn.functional.silu(x @ a)
        return torch.mean((h @ b - y) ** 2)

    def f(a, b, x, y):
        a, b = a.requires_grad_(True), b.requires_grad_(True)
        value = loss(a, b, x, y)
        return value, torch.autograd.grad(value, (a, b))

    args = [torch.empty(s, device=META) for s in ((64, 128), (128, 64),
                                                  (32, 64), (32, 64))]
    _, cost = op_cost.count(f, *args)
    mm = cost.rows["aten.mm"]

    def jf(params, x, y):
        def jloss(p):
            a, b = p
            h = jax.nn.silu(x @ a)
            return jnp.mean((h @ b - y) ** 2)
        return jax.value_and_grad(jloss)(params)

    params = (jax.ShapeDtypeStruct((64, 128), jnp.float32),
              jax.ShapeDtypeStruct((128, 64), jnp.float32))
    x = jax.ShapeDtypeStruct((32, 64), jnp.float32)
    hlo = jax.jit(jf).lower(params, x, x).compile().as_text()
    rows = jax_top_costs(hlo, k=10 ** 6)
    dots = sum(r["flops"] for r in rows if r["op"] == "dot")
    # forward: x @ a, h @ b; backward: dh = g b^T, db = h^T g, da = x^T dz
    assert mm.flops == 2 * 2 * 32 * 64 * 128 + 3 * 2 * 32 * 64 * 128
    assert mm.flops == pytest.approx(dots, rel=0.02)
    assert cost.totals()["flops"] == mm.flops
    top = cost.top(3)
    assert top == sorted(top, key=lambda r: -r["bytes"])
    assert set(top[0]) == {"bytes", "flops", "collective", "op", "trips",
                           "where"}


def test_ops_with_several_results_count_every_result():
    x = torch.empty((8, 32, 64), device=META)
    w, b = torch.empty(64, device=META), torch.empty(64, device=META)
    out, cost = op_cost.count(torch.nn.functional.layer_norm, x, (64,), w, b)
    row = cost.rows["aten.native_layer_norm"]
    # inputs x, w, b; results: the output, the mean and the rstd (8, 32, 1)
    want = 4 * (x.numel() + 64 + 64) + 4 * (out.numel() + 2 * 8 * 32)
    assert row.calls == 1 and row.bytes == want
    totals = cost.totals()
    assert totals["collectives"] == {} and totals["collective_bytes"] == 0.0
    assert op_cost.analyze(torch.nn.functional.layer_norm, x, (64,), w,
                           b) == totals


@pytest.mark.parametrize("S,T,causal,window", [
    (64, 64, True, 0), (64, 64, True, 16), (32, 80, True, 24),
    (48, 48, False, 0), (48, 48, False, 8), (80, 32, True, 0)])
def test_mask_pairs_count_the_mask(S, T, causal, window):
    want = int(ref.attention_mask(S, T, causal, window, "cpu").sum())
    assert flash_attention.mask_pairs(S, T, causal, window) == want


def _kernel_case(kernel):
    """(inputs, the entry point, its plain version, forward work, backward
    work) at a small shape."""
    def meta(*shape):
        return torch.empty(shape, device=META)
    if kernel == "flash_attention":
        q, k = meta(2, 4, 64, 16), meta(2, 2, 64, 16)
        kw = dict(causal=True, window=24)
        return ([q, k, meta(2, 2, 64, 16)],
                lambda *a: ops.flash_attention(*a, **kw),
                lambda *a: ref.flash_attention_reference(*a, **kw),
                flash_attention.forward_work(q, k, lse=True, **kw),
                flash_attention.backward_work(q, k, **kw))
    shape = (1, 32, 2, 8, 8, 16, 4)
    return ([meta(1, 32, 2, 8), meta(1, 32, 2), meta(2), meta(1, 32, 8),
             meta(1, 32, 8)],
            lambda *a: ops.ssd(*a, chunk=16)[0],
            lambda *a: ref.ssd_reference(*a, chunk=16)[0],
            ssd_scan.forward_work(*shape, states=True),
            ssd_scan.backward_work(*shape))


@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_scan"])
def test_kernels_on_meta_count_their_own_work(kernel):
    inputs, entry, plain, fwd, bwd = _kernel_case(kernel)

    def step(fn):
        def run(*ts):
            ts = [t.requires_grad_() for t in ts]
            return torch.autograd.grad(fn(*ts).sum(), ts)
        return run

    grads, cost = op_cost.count(step(entry), *inputs)
    assert [g.shape for g in grads] == [t.shape for t in inputs]
    rows = cost.rows
    for name, work in ((kernel, fwd), (f"{kernel}_backward", bwd)):
        row = rows[f"kernel.{name}"]
        assert (row.calls, row.bytes, row.flops) == (1, *work)
    assert any(r.within == kernel for r in rows.values())
    assert any(r.within == f"{kernel}_backward" for r in rows.values())
    outside = [r for r in rows.values() if not (r.within or r.kernel)]
    totals = cost.totals()
    assert totals["flops"] == sum(r.flops for r in outside) + fwd[1] + bwd[1]
    assert totals["bytes"] == sum(r.bytes for r in outside) + fwd[0] + bwd[0]
    # the plain versions' ops, as ordinary autograd of the plain version
    _, ordinary = op_cost.count(step(plain), *inputs)
    assert cost.totals(plain=True) == ordinary.totals()
    assert not any(r.kernel or r.within for r in ordinary.rows.values())


def test_gathers_read_what_they_pick():
    table = torch.empty((1000, 64), device=META)
    ids = torch.empty((16,), dtype=torch.int64, device=META)
    out, cost = op_cost.count(torch.nn.functional.embedding, ids, table)
    row = cost.rows["aten.embedding"]
    assert row.bytes == 8 * 16 + 2 * 4 * out.numel()
    _, cost = op_cost.count(lambda t: t.new_zeros((8, 8)).fill_(1.0), table)
    assert cost.rows["aten.new_zeros"].bytes == 4 * 64
    assert cost.rows["aten.fill_"].bytes == 4 * 64
