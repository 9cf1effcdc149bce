"""The port's training slice (``train/``, ``data/pipeline.py``,
``launch/steps.py``, ``launch/train.py``) against the JAX package's, on the
CPU in float32, and the counterparts of ``repro``'s own ``test_trainer``,
``test_checkpoint``, ``test_optimizer`` and ``test_data`` cases.

Both packages start from one set of weights (``repro``'s init, carried
across by ``params_from_numpy``) and, for the optimizer, from ``repro``'s
own gradients and AdamW state (``opt_state_from_numpy``). Tolerances:

* one AdamW update from identical inputs: parameters within 1e-6 absolute
  (the step is lr x ~1 = 5e-3), moments within 1e-6 of their largest
  entry; float32 arithmetic in ``repro``'s order, only the global norm's
  rounding differs (``optimizer.py``);
* the compressed update: the same, and the error feedback within 1e-6 of
  the largest gradient entry (the int8 codes equal, with one scale a
  stacked tensor on both sides; the feedback total - deq cancels two
  numbers of the gradient's size, which XLA rounds once, fused, and
  PyTorch twice). ``repro``'s update is jitted, as its train step runs
  it: op by op XLA divides by multiplying with the reciprocal and moves a
  code now and then;
* the microbatched step against the one-batch step and against
  ``repro``'s microbatched step: the loss and grad norm within 1e-5
  relative, the first moment (0.1 x the clipped gradient after one step)
  within 1e-4 of each leaf's largest entry or 1e-9. The parameters are
  not compared there: Adam's first step is ~lr x sign(g), and where g is
  ~0 its sign is rounding;
* a 5-step ``Trainer`` run against ``repro``'s: loss, ce, grad norm and lr
  within 1e-5 relative at every step, the parameters within 1e-3 (20x the
  largest gap seen, 5.3e-5: the sign flips above, 5 steps of lr 5e-3).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.data import TokenPipeline as JaxPipeline
from repro.launch import make_debug_mesh
from repro.launch import make_train_step as jax_make_train_step
from repro.models import build as jax_build
from repro.train import optimizer as jopt
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.configs import get
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_debug_mesh as torch_debug_mesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import build
from repro_torch.models.convert import opt_state_from_numpy, \
    params_from_numpy
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import (AdamWConfig, AdamWState, adamw,
                                         compressed_adamw, dequantize_int8,
                                         quantize_int8)
from repro_torch.train.trainer import StragglerMonitor, Trainer, \
    TrainerConfig
from repro_torch.train.tree import leaves, map_tree, unflatten

torch.set_num_threads(1)
CPU = torch.device("cpu")
CPU_MESH = torch_debug_mesh(device="cpu")


def _cfgs(vocab=64):
    """gemma3-1b's smoke cut in float32 with a small vocab, both packages
    (``repro``'s ``test_trainer.py`` setting)."""
    kw = dict(dtype="float32", remat="none", vocab=vocab)
    return (dataclasses.replace(jax_get("gemma3-1b").smoke(), **kw),
            dataclasses.replace(get("gemma3-1b").smoke(), **kw))


@pytest.fixture(scope="module")
def start():
    """``repro``'s initial weights as numpy, and both configs."""
    jcfg, cfg = _cfgs()
    tree = jax.tree.map(np.asarray, jax.jit(jax_build(jcfg).init)(
        jax.random.PRNGKey(0)))
    return jcfg, cfg, tree


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got_tree, want_tree, atol):
    for g, w in zip(leaves(got_tree), leaves(want_tree)):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= atol


# -- the optimizer against repro's --------------------------------------------

@pytest.mark.parametrize("compressed", [False, True])
def test_one_update_from_repro_grads_and_state_matches(start, compressed):
    jcfg, cfg, tree = start
    ocfg = dict(lr=5e-3, warmup_steps=2, total_steps=20)
    jinit, jupdate = (jopt.compressed_adamw if compressed
                      else jopt.adamw)(jopt.AdamWConfig(**ocfg))
    init, update = (compressed_adamw if compressed else adamw)(
        AdamWConfig(**ocfg))
    jmodel = jax_build(jcfg)
    batch = {k: jnp.asarray(v) for k, v in JaxPipeline(
        vocab=jcfg.vocab, batch=2, seq=32).batch_at(0).items()}
    grad = jax.jit(jax.grad(lambda p: jmodel.loss(p, batch)[0]))
    # repro's state after one update, and its next gradient
    jupdate = jax.jit(jupdate)
    p0 = _jax_tree(tree)
    p1, s1, _ = jupdate(grad(p0), jinit(p0), p0)
    g1 = grad(p1)
    p2, s2, m2 = jupdate(g1, s1, p1)

    np_ = lambda t: jax.tree.map(np.asarray, t)          # noqa: E731
    params = params_from_numpy(cfg, np_(p1))
    state = opt_state_from_numpy(cfg, np_(s1))
    assert type(state).__name__ == type(init(params)).__name__
    new, new_state, metrics = update(params_from_numpy(cfg, np_(g1)), state,
                                     params)
    _close(new, params_from_numpy(cfg, np_(p2)), atol=1e-6)
    want_state = opt_state_from_numpy(cfg, np_(s2))
    inner, want_inner = (new_state.inner, want_state.inner) if compressed \
        else (new_state, want_state)
    assert int(inner.step) == int(want_inner.step) == 2
    for got, want in ((inner.mu, want_inner.mu), (inner.nu, want_inner.nu)):
        scale = max(float(w.abs().max()) for w in leaves(want))
        _close(got, want, atol=1e-6 * scale)
    if compressed:
        scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(g1))
        _close(new_state.error, want_state.error, atol=1e-6 * scale)
    assert abs(float(metrics["grad_norm"]) - float(m2["grad_norm"])) \
        <= 1e-5 * float(m2["grad_norm"])
    assert abs(float(metrics["lr"]) - float(m2["lr"])) <= 1e-9


def test_schedule_matches_repro():
    from repro.train.optimizer import _schedule as jschedule

    from repro_torch.train.optimizer import _schedule
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=40)
    for step in (0, 1, 5, 10, 11, 25, 40, 55):
        want = float(jschedule(jopt.AdamWConfig(**kw), jnp.int32(step)))
        got = float(_schedule(AdamWConfig(**kw),
                              torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-10, step


def test_quantize_int8_matches_repro():
    x = np.random.default_rng(0).normal(0, 3, 1000).astype(np.float32)
    x[:4] = [127.5, -0.5, 0.5, 2.5]          # halves: round half to even
    jq, js = jopt.quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


# -- repro's test_optimizer.py cases ------------------------------------------

def _convex_problem(update_fn, init_fn, steps=200):
    params = {"w": torch.tensor([3.0, -2.0, 5.0])}
    target = torch.ones(3)
    state = init_fn(params)
    for _ in range(steps):
        grads = {"w": 2 * (params["w"] - target)}
        params, state, m = update_fn(grads, state, params)
    return float(((params["w"] - target) ** 2).sum()), m


def test_adamw_converges():
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                      total_steps=10_000)
    init, update = adamw(cfg)
    final, metrics = _convex_problem(update, init)
    assert final < 1e-2
    assert "grad_norm" in metrics and "lr" in metrics


def test_compressed_adamw_converges():
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                      total_steps=10_000)
    init, update = compressed_adamw(cfg)
    final, _ = _convex_problem(update, init)
    assert final < 5e-2


def test_quantize_roundtrip_bound():
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 3, 1000)
                         .astype(np.float32))
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-6
    assert q.dtype == torch.int8


def test_grad_clip_reports_the_norm_before_clipping():
    init, update = adamw(AdamWConfig(lr=0.0, grad_clip=1.0, warmup_steps=0))
    params = {"w": torch.zeros(3)}
    huge = {"w": torch.tensor([1e6, 0.0, 0.0])}
    _, state, m = update(huge, init(params), params)
    assert float(m["grad_norm"]) > 1e5
    assert float(state.mu["w"][0]) == pytest.approx(0.1, rel=1e-5)


def test_update_leaves_grads_and_keeps_step_on_the_device():
    init, update = adamw(AdamWConfig(lr=1e-2, warmup_steps=0))
    params = {"a": torch.ones(4), "b": [torch.ones(2, 2)]}
    grads = map_tree(lambda p: torch.full_like(p, 0.5), params)
    state = init(params)
    new, state, _ = update(grads, state, params)
    assert new["a"] is params["a"]                 # written in place
    assert all(float(g.min()) == 0.5 for g in leaves(grads))
    assert state.step.dtype == torch.int32 and state.step.shape == ()
    assert float(new["a"][0]) < 1.0


# -- the data pipeline --------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab=100, batch=4, seq=16, seed=1),
    dict(vocab=262144, batch=4, seq=64, seed=0),
    dict(vocab=50, batch=8, seq=33, seed=2, noise=0.0),
    dict(vocab=100, batch=8, seq=16, seed=0, n_hosts=2, host_id=1),
])
def test_token_pipeline_is_byte_identical_to_repros(kw):
    mine, theirs = TokenPipeline(**kw), JaxPipeline(**kw)
    for step in (0, 3, 17):
        a, b = mine.batch_at(step), theirs.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()


def test_pipeline_deterministic_sharded_shifted_and_learnable():
    p1 = TokenPipeline(vocab=100, batch=4, seq=16, seed=1)
    p2 = TokenPipeline(vocab=100, batch=4, seq=16, seed=1)
    assert np.array_equal(p1.batch_at(7)["tokens"], p2.batch_at(7)["tokens"])
    kw = dict(vocab=100, batch=8, seq=16, seed=0, n_hosts=2)
    h0 = TokenPipeline(host_id=0, **kw).batch_at(0)
    h1 = TokenPipeline(host_id=1, **kw).batch_at(0)
    assert h0["tokens"].shape == (4, 16)
    assert not np.array_equal(h0["tokens"], h1["tokens"])
    b = p1.batch_at(0)
    assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    b = TokenPipeline(vocab=50, batch=8, seq=64, seed=2,
                      noise=0.0).batch_at(0)
    succ = {}
    for row_t, row_l in zip(b["tokens"], b["labels"]):
        for t, l in zip(row_t, row_l):
            succ.setdefault(int(t), set()).add(int(l))
    assert max(len(v) for v in succ.values()) <= 4


# -- the train step -----------------------------------------------------------

def test_microbatched_step_matches_one_batch_and_repro(start):
    jcfg, cfg, tree = start
    ocfg = dict(lr=5e-3, warmup_steps=2, total_steps=20)
    batch = TokenPipeline(vocab=cfg.vocab, batch=4, seq=32).batch_at(1)
    mb = {k: v.reshape(2, 2, 32) for k, v in batch.items()}

    one = make_train_step(cfg, CPU_MESH, 4, 32,
                          opt_cfg=AdamWConfig(**ocfg)).fn
    two = make_train_step(cfg, CPU_MESH, 4, 32, microbatches=2,
                          opt_cfg=AdamWConfig(**ocfg)).fn
    init, _ = adamw(AdamWConfig(**ocfg))
    pa = params_from_numpy(cfg, tree)
    _, sa, ma = one(pa, init(pa), batch)
    pb = params_from_numpy(cfg, tree)
    _, sb, mb_metrics = two(pb, init(pb), mb)

    bundle = jax_make_train_step(jcfg, make_debug_mesh(1, 1), batch=4,
                                 seq=32, microbatches=2,
                                 opt_cfg=jopt.AdamWConfig(**ocfg))
    jinit, _ = jopt.adamw(jopt.AdamWConfig(**ocfg))
    jp = _jax_tree(tree)
    _, js, jm = jax.jit(bundle.fn)(jp, jinit(jp), _jax_tree(mb))

    assert abs(float(ma["loss"]) - float(mb_metrics["loss"])) <= 1e-5
    assert abs(float(mb_metrics["loss"]) - float(jm["loss"])) <= 1e-5
    # repro's quirk, kept: with microbatches "ce" is the whole loss
    assert float(mb_metrics["ce"]) == float(mb_metrics["loss"])
    assert abs(float(jm["ce"]) - float(jm["loss"])) == 0.0
    assert abs(float(mb_metrics["grad_norm"]) - float(jm["grad_norm"])) \
        <= 1e-5 * float(jm["grad_norm"])
    jmu = params_from_numpy(cfg, jax.tree.map(np.asarray, js.mu))
    for got, want in ((sb.mu, sa.mu), (sb.mu, jmu)):
        for g, w in zip(leaves(got), leaves(want)):
            bar = max(1e-4 * float(w.abs().max()), 1e-9)
            assert float((g - w).abs().max()) <= bar


def test_step_refuses_a_batch_of_another_shape(start):
    _, cfg, tree = start
    step = make_train_step(cfg, CPU_MESH, 4, 32, microbatches=2).fn
    params = params_from_numpy(cfg, tree)
    init, _ = adamw(AdamWConfig())
    batch = TokenPipeline(vocab=cfg.vocab, batch=4, seq=32).batch_at(0)
    with pytest.raises(ValueError, match="built for"):
        step(params, init(params), batch)             # not (M, B/M, S)
    with pytest.raises(ValueError, match="multiple"):
        make_train_step(cfg, CPU_MESH, 5, 32, microbatches=2)


def test_five_trainer_steps_match_repro(start, tmp_path):
    jcfg, cfg, tree = start
    ocfg = dict(lr=5e-3, warmup_steps=2, total_steps=5)
    jmodel = jax_build(jcfg)
    jinit, jupdate = jopt.adamw(jopt.AdamWConfig(**ocfg))

    @jax.jit
    def jstep(params, opt_state, batch):
        (loss, metrics), grads = jax.value_and_grad(
            jmodel.loss, has_aux=True)(params, batch)
        params, opt_state, om = jupdate(grads, opt_state, params)
        return params, opt_state, {**metrics, **om, "loss": loss}

    pipe = dict(vocab=cfg.vocab, batch=4, seq=32, noise=0.05)
    jp = _jax_tree(tree)
    jtr = JaxTrainer(jstep, jp, jinit(jp), JaxPipeline(**pipe),
                     JaxTrainerConfig(total_steps=5, ckpt_every=100,
                                      ckpt_dir=str(tmp_path / "jax")),
                     to_device=_jax_tree)
    jhist = jtr.run()

    init, _ = adamw(AdamWConfig(**ocfg))
    params = params_from_numpy(cfg, tree)
    tr = Trainer(make_train_step(cfg, CPU_MESH, 4, 32,
                                 opt_cfg=AdamWConfig(**ocfg)).fn,
                 params, init(params), TokenPipeline(**pipe),
                 TrainerConfig(total_steps=5, ckpt_every=100,
                               ckpt_dir=str(tmp_path / "torch")))
    hist = tr.run()
    assert [h["step"] for h in hist] == [h["step"] for h in jhist]
    for h, jh in zip(hist, jhist):
        for key in ("loss", "ce", "grad_norm", "lr"):
            assert abs(h[key] - jh[key]) <= 1e-5 * max(1.0, abs(jh[key])), \
                (h["step"], key, h[key], jh[key])
    _close(tr.params, params_from_numpy(cfg, jax.tree.map(np.asarray,
                                                          jtr.params)),
           atol=1e-3)


def test_prefill_and_decode_steps_are_greedy(start):
    _, cfg, tree = start
    params = params_from_numpy(cfg, tree)
    model = build(cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)).astype(
        np.int32)
    prefill = make_prefill_step(cfg, CPU_MESH, 2, 24).fn
    decode = make_decode_step(cfg, CPU_MESH, 2, 24).fn
    nxt, cache = prefill(params, {"tokens": toks})
    logits, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                              max_seq=24)
    assert nxt.dtype == torch.int32
    assert torch.equal(nxt, logits.argmax(-1).int())
    nxt2, cache = decode(params, nxt[:, None], cache)
    assert nxt2.shape == (2, 1) and int(cache["pos"][0]) == 13


# -- repro's test_trainer.py cases --------------------------------------------

def _parts(tmp_path, steps):
    _, cfg = _cfgs()
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=steps)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    init, _ = adamw(ocfg)
    step = make_train_step(cfg, CPU_MESH, 4, 32, opt_cfg=ocfg).fn
    pipe = TokenPipeline(vocab=cfg.vocab, batch=4, seq=32, noise=0.05)
    return step, params, init(params), pipe


def test_loss_decreases(tmp_path):
    step, params, opt, pipe = _parts(tmp_path, 30)
    hist = Trainer(step, params, opt, pipe,
                   TrainerConfig(total_steps=30, ckpt_every=100,
                                 ckpt_dir=str(tmp_path))).run()
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.1, (first, last)


def test_checkpoint_resume(tmp_path):
    step, params, opt, pipe = _parts(tmp_path, 10)
    tr = Trainer(step, params, opt, pipe,
                 TrainerConfig(total_steps=10, ckpt_every=5,
                               ckpt_dir=str(tmp_path)))
    tr.run()
    step2, params2, opt2, pipe2 = _parts(tmp_path, 12)   # "crash", restart
    tr2 = Trainer(step2, params2, opt2, pipe2,
                  TrainerConfig(total_steps=12, ckpt_every=50,
                                ckpt_dir=str(tmp_path)))
    assert tr2.maybe_restore() == 10
    assert int(tr2.opt_state.step) == 10
    for a, b in zip(leaves(tr2.params), leaves(tr.params)):
        assert torch.equal(a, b)
    hist = tr2.run()
    assert hist[-1]["step"] == 12


def test_straggler_monitor():
    mon = StragglerMonitor(threshold=2.0)
    for i in range(10):
        mon.record(i, 0.1)
    assert mon.record(11, 0.5)
    assert 11 in mon.stragglers
    for i in range(12, 20):
        assert not mon.record(i, 0.11)


def test_launcher_trains_on_cpu(tmp_path, capsys):
    hist = launch_train.main(["--device", "cpu", "--steps", "12",
                              "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 12
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert "loss " in capsys.readouterr().out
    assert CheckpointManager(tmp_path).latest_step() == 12
    with pytest.raises(ValueError, match="frames"):
        launch_train.main(["--arch", "whisper-large-v3", "--device", "cpu"])


def test_launcher_trains_mamba2_on_cpu(tmp_path):
    """mamba2-370m's smoke cut through the launcher: the SSD scan's
    gradient is the plain one on the CPU (on the card, its backward
    kernel); 12 steps, the loss finite and falling, the last checkpoint
    at step 12."""
    hist = launch_train.main(["--arch", "mamba2-370m", "--device", "cpu",
                              "--steps", "12", "--batch", "4", "--seq", "64",
                              "--ckpt-dir", str(tmp_path)])
    losses = [h["loss"] for h in hist]
    assert len(hist) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert CheckpointManager(tmp_path).latest_step() == 12


# -- repro's test_checkpoint.py cases -----------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1.5, -2.25, 3.0, 2 ** -9],
                                    dtype=torch.bfloat16)}}


def test_save_restore_roundtrip_keeps_bf16_bits(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    t = _tree()
    mgr.save(10, t, blocking=True)
    out = mgr.restore(t)
    assert torch.equal(out["a"], t["a"])
    assert out["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(out["b"]["c"].view(torch.int16),
                       t["b"]["c"].view(torch.int16))


def test_restore_takes_the_like_leaves_dtype_and_structure(tmp_path):
    mgr = CheckpointManager(tmp_path)
    init, _ = adamw(AdamWConfig())
    params = {"w": torch.ones(2, 2), "layers": [{"x": torch.zeros(3)}]}
    state = init(params)
    mgr.save(4, (params, state), blocking=True)
    like = (map_tree(lambda p: p.double(), params), init(params))
    got_params, got_state = mgr.restore(like)
    assert isinstance(got_state, AdamWState)
    assert got_params["w"].dtype == torch.float64
    assert got_state.step.dtype == torch.int32
    assert unflatten(params, leaves(params)) == params


def test_latest_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _tree(), blocking=True)
    assert mgr.latest_step() == 4
    assert mgr.steps() == [3, 4]


def test_no_tmp_left_behind(tmp_path):
    CheckpointManager(tmp_path).save(7, _tree(), blocking=True)
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_async_save_snapshots_before_returning(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(5, t)                  # async
    t["a"].add_(100.0)              # the caller moves on, in place
    mgr.wait()
    assert mgr.latest_step() == 5
    assert float(mgr.restore(t)["a"][0, 0]) == 0.0


def test_async_save_error_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(tmp_path)
    (tmp_path / "step_3.tmp").write_text("a file where a directory goes")
    mgr.save(3, _tree())
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                      # reported once


def test_structure_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree(), blocking=True)
    with pytest.raises(ValueError):
        mgr.restore({"only": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"a": torch.zeros(3, 2), "b": {"c": torch.zeros(4)}})


def test_restore_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path).restore(_tree())
