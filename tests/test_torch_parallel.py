"""Tensor- and data-parallel serving of the PyTorch port (``parallel/``) on
the CPU: the ranks are processes over gloo (``tests/torch_parallel_ranks.py``,
spawned once per file: a tp=2 group and a group of 4 ranks, meshes (4,) and
("dp", "tp") = (2, 2), at once), each case its own test.

The cases of the JAX package's ``tests/parallel/test_serving.py``,
``test_cb_serving.py`` and ``test_spec_serving.py``, at their sizes (GPT-2
2 x 128 and 2 x 256, T5 and Whisper of 2 layers): greedy tokens of every TP
generator and pool equal the port's single-device tokens, each TP class
once also the JAX package's own TP class on the 8 virtual CPU devices; the
sampled streams agree on every rank. The weights are the JAX init's
(position tables and T5's rel-pos tables seeded non-zero so the streams
move), bridged to the port through numpy.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_models_tpu.models.audio2text.whisper import Whisper as JaxWhisper
from pytorch_models_tpu.models.text import GPT2 as JaxGPT2
from pytorch_models_tpu.models.text import T5Model as JaxT5
from pytorch_models_tpu.parallel import make_mesh as jax_make_mesh
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.audio2text import WhisperGenerator
from pytorch_models_tpu_torch.text import ContinuousBatchingGenerator, DecoderGenerator, T5Generator
from tests.torch_parallel_ranks import Tok, build, run_ranks

torch.set_num_threads(1)


def _gpt2(n_layers, d, rng=0):
    JaxGPT2.vocab_size, JaxGPT2.max_seq_len = 128, 128
    try:
        m = JaxGPT2(n_layers, d, rng=rng)
    finally:
        JaxGPT2.vocab_size, JaxGPT2.max_seq_len = 50257, 1024
    tree = jax.tree.map(to_np, m.params)
    tree["pos_embs"] = (3 * np.random.default_rng(rng).standard_normal(tree["pos_embs"].shape)).astype(np.float32)
    return ("gpt2", dict(n_layers=n_layers, d_model=d, rng=rng, vocab_size=128, max_seq_len=128), tree)


def _t5(**kw):
    tree = jax.tree.map(to_np, JaxT5(**kw).params)
    r = np.random.default_rng(kw["dim"])
    for stack in ("encoder", "decoder"):
        tree[stack]["attn_bias"] = (2 * r.standard_normal(tree[stack]["attn_bias"].shape)).astype(np.float32)
    return ("t5", kw, tree)


def _whisper(**kw):
    tree = jax.tree.map(to_np, JaxWhisper(**kw).params)
    pos = tree["decoder"]["pos_embs"]
    tree["decoder"]["pos_embs"] = np.random.default_rng(5).standard_normal(pos.shape).astype(np.float32)
    return ("whisper", kw, tree)


def _audios(n, seconds, seed):
    r = np.random.default_rng(seed)
    return [(r.standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32) for _ in range(n)]


MODELS = {
    "gpt2_128": _gpt2(2, 128),  # 2 heads
    "gpt2_256": _gpt2(2, 256),  # 4 heads
    "gpt2_256_l4": _gpt2(4, 256),
    "gpt2_256_l2": _gpt2(2, 256, rng=7),
    "t5_128": _t5(vocab_size=100, dim=128, n_heads=2, n_layers=2, mlp_dim=256),
    "t5_64": _t5(vocab_size=96, dim=64, n_heads=4, n_layers=2, mlp_dim=128),
    "whisper_128": _whisper(vocab_size=64, n_layers=2, d_model=128),  # 2 heads
}
_R = np.random.default_rng(13)
CASES = {
    "prompts": [[5, 6, 7], [11] * 40, [3, 4], [8, 2, 6, 1]],
    "cb_requests": [[5, 6, 7], [9] * 12, [11, 12], [3] * 7, [8, 1, 2, 6], [4] * 5],
    "cb_budgets": [8, 5, 11, 8, 3, 9],
    "epoch_requests": [[5, 6, 7]] * 6 + [[9] * 10] * 6,
    "prefix": [2, 7, 1, 8, 2, 8],
    "prefix_requests": [[5, 6, 7], [9] * 12, [11, 12], [3] * 7],
    "prefix_budgets": [8, 5, 11, 6],
    "sample_requests": [[5, 6, 7], [9] * 12, [11, 12]],
    "sample_budgets": [8, 5, 9],
    "sample_kw": dict(topk=4, temperature=0.9, seed=7),
    "long_requests": [[i % 120 for i in range(2, 41)], [5, 6], [i * 3 % 117 for i in range(19)]],
    "long_budgets": [6, 9, 5],
    "long_prefix": [7, 3, 1, 8, 2],
    "t5_prompts": [[7, 8, 9, 4], [5] * 9, [3, 2], [1, 2, 3]],
    "t5cb_requests": [_R.integers(2, 96, size=n).tolist() for n in (5, 30, 11, 68, 3)],
    "w_audios": _audios(4, 2, 0),
    "wcb_audios": _audios(4, 1, 7),
    "wcb_init": [50, 51],
    "spec_prompt": [5, 6, 7, 11, 2],
    "spec_prompt3": [5, 6, 7],
}


def _port(name):
    return build(MODELS[name])


def _jax_model(name):
    kind, kw, tree = MODELS[name]
    if kind == "gpt2":
        JaxGPT2.vocab_size, JaxGPT2.max_seq_len = kw["vocab_size"], kw["max_seq_len"]
        try:
            m = JaxGPT2(kw["n_layers"], kw["d_model"], rng=kw["rng"])
        finally:
            JaxGPT2.vocab_size, JaxGPT2.max_seq_len = 50257, 1024
    else:
        m = (JaxT5 if kind == "t5" else JaxWhisper)(**kw)
    m.params = jax.tree.map(jnp.asarray, tree)
    return m


def _spec_eos_ids():
    """EOS ids that land at offsets 5 (the identical-draft case) and 1, 2, 3
    into a chunk of 4 (mid-chunk EOS): tokens of the target's own greedy
    stream after the 3-token prompt."""
    base = DecoderGenerator(_port("gpt2_256_l4"), Tok()).generate_tokens(CASES["spec_prompt3"], max_tokens=16)
    return [base[3 + off] for off in (5, 1, 2, 3)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results: ``(tp2, world4)``, each a list over the ranks."""
    cases = dict(CASES, spec_eos_ids=_spec_eos_ids())
    tp2, world4 = run_ranks([(2, "serving_tp2", (MODELS, cases)), (4, "serving_world4", (MODELS, cases))],
                            tmp_path_factory.mktemp("tp"))
    return SimpleNamespace(tp2=tp2, world4=world4, cases=cases)


def _same_on_every_rank(results, key):
    """The ranks' results under ``key``, which must agree; returns rank 0's."""
    for r, res in enumerate(results):
        assert res[key] == results[0][key], f"rank {r} parts from rank 0 on {key}"
    return results[0][key]


def _moves(rows, n_prompt):
    """The greedy streams are not stuck on one token."""
    assert len({t for row, n in zip(rows, n_prompt) for t in row[n:]}) > 2


# ---- serving.py ------------------------------------------------------------


def test_tp_generation_matches_single_device(ranks):
    m = _port("gpt2_128")
    baseline = DecoderGenerator(m, Tok()).generate_tokens_batch(CASES["prompts"], max_tokens=12)
    _moves(baseline, [len(p) for p in CASES["prompts"]])
    assert _same_on_every_rank(ranks.world4, "dp_tp") == baseline
    from pytorch_models_tpu.parallel.serving import TPDecoderGenerator as JaxTP

    jax_tp = JaxTP(_jax_model("gpt2_128"), Tok(), jax_make_mesh(4, shape=(2, 2), axes=("dp", "tp")))
    assert jax_tp.generate_tokens_batch(CASES["prompts"], max_tokens=12) == baseline


def test_tp_only_mesh_matches_single_device(ranks):
    baseline = DecoderGenerator(_port("gpt2_128"), Tok()).generate_tokens_batch(CASES["prompts"], max_tokens=6)
    assert _same_on_every_rank(ranks.tp2, "tp_only") == baseline


def test_tp_sampling_runs(ranks):
    """dp x tp = 2 x 2, top-k 3: each dp shard draws its own stream, and the
    tp ranks of a shard draw the same tokens (all four ranks return the
    whole, identical list)."""
    outs = _same_on_every_rank(ranks.world4, "sample")
    assert len(outs) == 4
    for p, o in zip(CASES["prompts"], outs):
        assert o[: len(p)] == p and len(p) < len(o) <= len(p) + 5


def test_tp_t5_generation_matches_single_device(ranks):
    baseline = T5Generator(model=_port("t5_128")).generate_tokens_batch(CASES["t5_prompts"], 10, 0, 1)
    _moves(baseline, [1] * 4)
    assert _same_on_every_rank(ranks.world4, "t5") == baseline
    from pytorch_models_tpu.parallel.serving import TPT5Generator as JaxTP

    jax_tp = JaxTP(_jax_model("t5_128"), object(), jax_make_mesh(4, shape=(2, 2), axes=("dp", "tp")))
    assert jax_tp.generate_tokens_batch(CASES["t5_prompts"], 10, 0, 1) == baseline


def test_tp_whisper_transcription_matches_single_device(ranks):
    baseline = WhisperGenerator(_port("whisper_128")).transcribe_tokens_batch(CASES["w_audios"], [1, 2], eot_id=-1,
                                                                               max_tokens=8)
    assert _same_on_every_rank(ranks.world4, "whisper") == baseline
    from pytorch_models_tpu.parallel.serving import TPWhisperGenerator as JaxTP

    jax_tp = JaxTP(_jax_model("whisper_128"), jax_make_mesh(4, shape=(2, 2), axes=("dp", "tp")))
    assert jax_tp.transcribe_tokens_batch(CASES["w_audios"], [1, 2], eot_id=-1, max_tokens=8) == baseline


# ---- cb_serving.py ---------------------------------------------------------


def _plain_many(name, requests, budgets, prefix=()):
    plain = DecoderGenerator(_port(name), Tok())
    return [plain.generate_tokens(list(prefix) + r, max_tokens=mt) for r, mt in zip(requests, budgets)]


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_cb_matches_single_device_per_request(ranks, tp):
    ref = _plain_many("gpt2_256", CASES["cb_requests"], CASES["cb_budgets"])
    _moves(ref, [len(r) for r in CASES["cb_requests"]])
    assert _same_on_every_rank(ranks.tp2 if tp == 2 else ranks.world4, "cb") == ref
    if tp == 2:
        from pytorch_models_tpu.parallel.cb_serving import TPContinuousBatchingGenerator as JaxTP

        jax_tp = JaxTP(_jax_model("gpt2_256"), Tok(), jax_make_mesh(2, shape=(2,), axes=("tp",)), batch_size=3,
                       prompt_bucket=16, check_every=4)
        assert jax_tp.generate_tokens_many(CASES["cb_requests"], CASES["cb_budgets"]) == ref


def test_tp_cb_epoch_reset_path(ranks):
    """More work than one epoch fits: the pool drains, resets and still
    reproduces every request."""
    ref = _plain_many("gpt2_256", CASES["epoch_requests"], [40] * 12)
    assert _same_on_every_rank(ranks.tp2, "cb_epoch") == ref
    assert ranks.tp2[0]["cb_epoch_resets"] > 0


def test_tp_cb_shared_prefix_matches_single_device(ranks):
    ref = _plain_many("gpt2_256", CASES["prefix_requests"], CASES["prefix_budgets"], CASES["prefix"])
    assert _same_on_every_rank(ranks.tp2, "cb_prefix") == ref


def test_tp_cb_sampling_matches_single_device(ranks):
    """Sampling under tp: the hidden state is all-reduced and the head and
    the counter-based uniforms are the same on every rank, so the ranks
    draw the same tokens, the single-device pool's."""
    ref = ContinuousBatchingGenerator(_port("gpt2_256"), Tok(), batch_size=2, prompt_bucket=16, check_every=4) \
        .generate_tokens_many(CASES["sample_requests"], CASES["sample_budgets"], **CASES["sample_kw"])
    assert _same_on_every_rank(ranks.tp2, "cb_sample") == ref


def test_tp_cb_cache_is_head_sharded(ranks):
    shapes = ranks.world4[0]["pool_shapes"]
    assert shapes["k"] == shapes["v"] == (2, 2, 128, 256 // 4)


def test_mesh_collectives_sharding_and_the_fused_gate(ranks):
    """Four ranks: row-major coordinates on ("dp", "tp") = (2, 2), psum /
    pmax over tp and the dp gather of rows; ``shard_decoder_lm_params``'
    Megatron kernel splits (biases whole, as the JAX package's GSPMD specs);
    the fused step refused for a tp rank's layers."""
    for rank, res in enumerate(ranks.world4):
        psum, pmax, gathered, dp, tp = res["collectives"]
        assert (dp, tp) == divmod(rank, 2)
        assert psum == [6.0, -6.0] and pmax == [3.0, 0.0]
        assert gathered == [tp, tp + 2]
        assert res["fused_gate"] == (False, True)
        assert res["gspmd_shapes"] == {"q.w": (256, 64), "q.b": (256,), "o.w": (64, 256), "fc1.w": (256, 256),
                                       "fc2.w": (256, 256), "fc2.b": (256,)}


@pytest.mark.parametrize("tp", [2])
def test_tp_whisper_cb_matches_single_device_per_segment(ranks, tp):
    plain = WhisperGenerator(_port("whisper_128"))
    ref = [plain.transcribe_tokens(a, CASES["wcb_init"], 63, max_tokens=10) for a in CASES["wcb_audios"]]
    assert _same_on_every_rank(ranks.tp2, "wcb") == ref
    from pytorch_models_tpu.parallel.cb_serving import TPWhisperContinuousBatchingGenerator as JaxTP

    jax_tp = JaxTP(_jax_model("whisper_128"), jax_make_mesh(tp, shape=(tp,), axes=("tp",)), batch_size=2,
                   check_every=3, pool_ctx=48)
    assert jax_tp.transcribe_tokens_many(CASES["wcb_audios"], CASES["wcb_init"], 63, max_tokens=10) == ref


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_t5_cb_matches_single_device_per_request(ranks, tp):
    plain = T5Generator(model=_port("t5_64"))
    ref = [plain.generate_tokens(ts, 14, 0, 1) for ts in CASES["t5cb_requests"]]
    assert _same_on_every_rank(ranks.tp2 if tp == 2 else ranks.world4, "t5cb") == ref
    if tp == 2:
        from pytorch_models_tpu.parallel.cb_serving import TPT5ContinuousBatchingGenerator as JaxTP

        jax_tp = JaxTP(_jax_model("t5_64"), jax_make_mesh(2, shape=(2,), axes=("tp",)), batch_size=2,
                       check_every=4, pool_ctx=64)
        assert jax_tp.generate_tokens_many(CASES["t5cb_requests"], 14, 0, 1) == ref


def test_tp_cb_chunked_prefill_long_prompts(ranks):
    """Prompts longer than the bucket admit by chunked prefill, with and
    without a shared prefix."""
    assert _same_on_every_rank(ranks.tp2, "cb_chunked") == _plain_many("gpt2_256", CASES["long_requests"],
                                                                        CASES["long_budgets"])
    assert _same_on_every_rank(ranks.tp2, "cb_chunked_prefix") == _plain_many(
        "gpt2_256", CASES["long_requests"], CASES["long_budgets"], CASES["long_prefix"])


# ---- spec_serving.py -------------------------------------------------------


@pytest.mark.parametrize("tp,k", [(2, 3), (4, 4)])
def test_tp_speculative_matches_single_device_greedy(ranks, tp, k):
    ref = DecoderGenerator(_port("gpt2_256_l4"), Tok()).generate_tokens(CASES["spec_prompt"], max_tokens=16)
    assert _same_on_every_rank(ranks.tp2 if tp == 2 else ranks.world4, "spec") == ref
    if tp == 2:
        from pytorch_models_tpu.parallel.spec_serving import TPSpeculativeGenerator as JaxTP

        jax_tp = JaxTP(_jax_model("gpt2_256_l4"), _jax_model("gpt2_256_l2"), Tok(),
                       jax_make_mesh(2, shape=(2,), axes=("tp",)), k=k)
        assert jax_tp.generate_tokens(CASES["spec_prompt"], max_tokens=16) == ref


def test_tp_speculative_identical_draft_and_eos(ranks):
    eos = ranks.cases["spec_eos_ids"][0]
    ref = DecoderGenerator(_port("gpt2_256_l4"), Tok(eos)).generate_tokens(CASES["spec_prompt3"], max_tokens=16)
    assert _same_on_every_rank(ranks.tp2, "spec_eos")[0] == ref


def test_draft_params_replicated_target_sharded(ranks):
    target_q, draft_q = ranks.world4[0]["spec_q_shapes"]
    assert target_q == (256, 256 // 4) and draft_q == (256, 256)


def test_tp_speculative_mid_chunk_eos_truncates(ranks):
    """EOS mid-chunk (offsets 1, 2, 3 of an identical draft's accepted chunk
    of 4): the tokens past it are cut, as the plain loop stops."""
    outs = _same_on_every_rank(ranks.tp2, "spec_eos")[1:]
    for eos, out in zip(ranks.cases["spec_eos_ids"][1:], outs):
        ref = DecoderGenerator(_port("gpt2_256_l4"), Tok(eos)).generate_tokens(CASES["spec_prompt3"], max_tokens=16)
        assert out == ref, (eos, out, ref)
