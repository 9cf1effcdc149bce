"""The encoder-decoder's (whisper-large-v3) step bundles and gemma3-1b's
with its mixed local:global ring cache, in one 4-rank ``gloo`` world on
the CPU meshed (2, 2), (4, 1) and (1, 4), at the smoke cuts and bars of
``tests/torch_mesh_world.py``, against the one-device steps and
``repro``'s.

* whisper-large-v3 (2 encoder and 2 decoder layers, 4 heads on 2 kv
  heads, d_head 16, vocab 66, its biases and LayerNorm scales drawn from
  a seed): 4 clips of 64 frames and an 8-token prompt, the bundles built
  with seq = 64 frames, so the cross cache holds 64 frames and the self
  cache 448 slots. Its projections are biased, and the row-parallel ones
  (``wo``, ``down``) come out ``Partial()`` over "model": a bias added
  once a rank would move every logit. Its vocab of 66 splits over a
  "model" of 2 but not of 4, so on (1, 4) the table stays whole over
  "model" (the embed rule's fallback). The prefill's and the decode
  steps' tokens also equal ``repro``'s jitted ones. A decode step reads
  both caches gathered over "model".
* gemma3-1b with ``mixed_cache=True`` (7 layers: 6 local on a ring of
  W = 16 slots, 1 global): a mixed cache has no prefill, and its prefill
  step raises ``Model.prefill``'s ``ValueError`` on the mesh as on one
  device. 20 decode steps from a placed ``init_cache`` run past the
  ring's wrap at 16. The ring is sharded over "model", so the wrap writes
  slot 0 on the first "model" rank. Tokens equal the one-device steps'
  and ``repro``'s ``decoder_decode_mixed``'s, and every cache leaf is
  within 1e-5 of its largest entry. ``mixed_cache`` changes the decode
  cache alone, so of the train steps it runs the plain one: gemma3-1b's
  compressed and microbatched steps are ``test_torch_mesh_dist.py``'s.
"""
import pytest
import torch

import torch_mesh_world as W
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import DEC_LEN

torch.set_num_threads(1)
WHISPER, MIXED = "whisper-large-v3", "gemma3-1b" + W.MIXED
ARCHS = (WHISPER, MIXED)
JOIN_S = 600


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The world's results and the references, computed while it runs."""
    inits = {arch: W.repro_init(arch) for arch in ARCHS}

    def references():
        return {arch: W.reference(init, tokens=True)
                for arch, init in inits.items()}
    return W.spawn(tmp_path_factory.mktemp("world"),
                   {arch: init["inp"] for arch, init in inits.items()},
                   JOIN_S, meanwhile=references)


def _ids(case):
    return f"{case[0]}-{case[1][0]}x{case[1][1]}"


@pytest.fixture(params=[(a, s) for a in ARCHS for s in W.MESHES], ids=_ids)
def case(request, run):
    """(reference, mesh shape, the ranks' results) of one config on one
    mesh."""
    arch, shape = request.param
    return run[1][arch], shape, run[0][arch, shape]


def _on(arch):
    return pytest.mark.parametrize(
        "case", [(arch, s) for s in W.MESHES], ids=_ids, indirect=True)


def test_prefill_matches_one_device(case):
    """whisper's tokens, logits and caches; the mixed cache's prefill step
    raises the one-device step's ``ValueError``."""
    ref, _, ranks = case
    if ref["cfg"].mixed_cache:
        assert "mixed_cache has no prefill" in ref["one"]["prefill_raises"]
    W.check_prefill(ranks[0], ref["one"])


def test_decode_matches_one_device_in_place(case):
    ref, _, ranks = case
    W.check_decode(ranks, ref["one"])


def test_tokens_match_repro(case):
    """The prefill's token and every decode step's, on one device and on
    every rank, equal ``repro``'s jitted steps' on the same weights."""
    ref, _, ranks = case
    for res in [ref["one"], *ranks]:
        if "jax_prefill_tok" in ref:
            assert torch.equal(res["prefill_tok"].long(),
                               ref["jax_prefill_tok"].long())
        assert torch.equal(res["decode_tok"].long(),
                           ref["jax_decode_tok"].long())


def test_train_step_matches_one_device_and_repro(case):
    ref, _, ranks = case
    W.check_train(ranks[0], ref["one"], ref)


@_on(WHISPER)
def test_compressed_train_step_matches_one_device_and_repro(case):
    ref, _, ranks = case
    W.check_compressed(ranks[0], ref["one"], ref)


@_on(WHISPER)
def test_microbatched_train_step_matches_one_device(case):
    ref, _, ranks = case
    W.check_microbatched(ranks[0], ref["one"])


def test_local_bytes_are_the_dry_runs(case):
    W.check_bytes(case[2])


def test_restore_onto_the_mesh_is_bitwise(case):
    assert all(res["restored_bitwise"] for res in case[2])


@_on(WHISPER)
def test_decode_gathers_both_caches_over_model(case):
    """The bytes each rank receives a decode step to read the self cache
    (448 slots) and the cross cache (64 frames), both sharded by sequence
    over "model", in the decode kernel's placements
    (``ops.GATHERED_KV_BYTES``): (model - 1) / model of its rows' whole
    cache where its 2 kv heads do not split over "model" (a gather, on
    (1, 4)); (model - 1) / model of its kv heads' share where they do (an
    all-to-all from sequence shards to head shards, on (2, 2)); 0 where
    "model" is 1."""
    ref, (data, model), ranks = case
    cfg = ref["cfg"]
    kh = cfg.n_kv_heads
    kh_local = kh // model if kh % model == 0 else kh
    local = (W.B // data) * (DEC_LEN + W.FRAMES) * kh_local * cfg.d_head * 4
    want = W.DECODES * cfg.n_layers * 2 * local * (model - 1) // model
    assert ref["one"]["decode_gathered_bytes"] == 0
    for res in ranks:
        assert res["decode_gathered_bytes"] == want


@_on(WHISPER)
def test_vocab_table_stays_whole_where_model_does_not_divide_it(case):
    """The embed rule takes vocab over "model" where "model" divides 66
    (2 ranks) and falls back to the width over "data" alone (4 ranks):
    the lookup then reads whole rows (``spmd.embed``), and the prefill
    test above holds its result."""
    ref, shape, _ = case
    mesh = Mesh(shape, ("data", "model"),
                [torch.device("cpu")] * (shape[0] * shape[1]))
    tr = make_train_step(ref["cfg"], mesh.abstract(), W.B, W.FRAMES)
    spec = tuple(tr.in_shardings[0]["embed"].spec)
    assert spec == {(2, 2): ("model", "data"), (4, 1): ("model", "data"),
                    (1, 4): (None, "data")}[shape]


@_on(MIXED)
def test_mixed_decode_runs_past_the_rings_wrap(case):
    """20 steps on a ring of 16: every rank's cursor is past the wrap, and
    its ring slots hold the one-device ring's (the decode test above)."""
    ref, _, ranks = case
    cfg = ref["cfg"]
    assert cfg.window == 16 < W.MIXED_DECODES
    for res in [ref["one"], *ranks]:
        assert res["decode_cache"]["pos"].tolist() == [W.MIXED_DECODES] * W.B
        assert res["decode_cache"]["k_local"].shape[2] == cfg.window
