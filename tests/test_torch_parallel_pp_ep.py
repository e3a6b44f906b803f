"""Pipeline-, tensor x pipeline- and expert-parallel serving of the PyTorch
port (``parallel/pp_serving.py``, ``tp_pp_serving.py``, ``ep_serving.py``)
on the CPU: the ranks are processes over gloo
(``tests/torch_parallel_ranks.py``, spawned once for worlds of 2, 4 and 8
ranks at once).

The cases of the JAX package's ``tests/parallel/test_pp_serving.py``,
``test_tp_pp_serving.py`` and ``test_ep_serving.py`` at their sizes (GPT-2
4 x 128 and 4 x 256 at vocab and context 128, the MoE decoder's defaults):
greedy tokens of every generator equal the port's single-device
generator's and the JAX package's own parallel class's on the 8 virtual
CPU devices; each rank holds its stage's layers and caches (and its shard
of the heads or experts); EOS stops early (TP x PP) and in lockstep (EP);
the EP generator really calls ``all_to_all``, twice per layer a forward.
The GPT-2 position tables are seeded non-zero so the streams move.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_models_tpu.models.text import GPT2 as JaxGPT2
from pytorch_models_tpu.parallel import make_mesh as jax_make_mesh
from pytorch_models_tpu.parallel.ep_serving import EPMoEGenerator as JaxEP
from pytorch_models_tpu.parallel.ep_serving import MoEDecoderConfig as JaxMoECfg
from pytorch_models_tpu.parallel.ep_serving import MoEDecoderGenerator as JaxMoEGen
from pytorch_models_tpu.parallel.ep_serving import moe_decoder_init as jax_moe_init
from pytorch_models_tpu.parallel.pp_serving import PPDecoderGenerator as JaxPP
from pytorch_models_tpu.parallel.tp_pp_serving import TPPPDecoderGenerator as JaxTPPP
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.parallel.ep_serving import MoEDecoderConfig, MoEDecoderGenerator
from pytorch_models_tpu_torch.parallel.pp_serving import stage_stack
from pytorch_models_tpu_torch.text import DecoderGenerator
from pytorch_models_tpu_torch.utils import from_jax_params, to_jax_params
from tests.torch_parallel_ranks import Tok, build, run_ranks

torch.set_num_threads(1)


def _gpt2(d, seed):
    JaxGPT2.vocab_size, JaxGPT2.max_seq_len = 128, 128
    try:
        m = JaxGPT2(4, d, rng=seed)
    finally:
        JaxGPT2.vocab_size, JaxGPT2.max_seq_len = 50257, 1024
    tree = jax.tree.map(to_np, m.params)
    tree["pos_embs"] = (3 * np.random.default_rng(seed).standard_normal(tree["pos_embs"].shape)).astype(np.float32)
    return ("gpt2", dict(n_layers=4, d_model=d, rng=seed, vocab_size=128, max_seq_len=128), tree)


def _moe(seed):
    return jax.tree.map(to_np, jax_moe_init(jax.random.PRNGKey(seed), JaxMoECfg(n_layers=2, n_experts=4,
                                                                                  max_seq_len=64)))


MODELS = {"gpt2_128_l4": _gpt2(128, 0), "gpt2_256_l4": _gpt2(256, 1), "moe0": _moe(0), "moe1": _moe(1)}
PROMPTS = [[5, 6, 7], [9] * 20, [11, 12], [3] * 7]
EOS_PROMPTS = [[5, 6, 7], [9] * 11]
EP_CFG = dict(n_layers=2, n_experts=4, max_seq_len=64)
# each prompt twice: at ep=4 a rank's two rows are one stream, and 239 (of the [3, 4] stream alone) ends
# rank 2's rows early while the other ranks' run to the budget
EP_PROMPTS = {"moe0": PROMPTS, "moe1": [[i // 2 + 1, i // 2 + 2] for i in range(8)]}
EP_KW = {"moe0": dict(max_tokens=8), "moe1": dict(max_tokens=12, eos_id=239)}
TP_PP = {8: [(2, 4), (4, 2), (2, 2, 2)], 4: [(2, 2)]}
# the MoE generators' stop: no new token asked for, and a prompt whose bucket of 8 fills the context of 64
EP_SHORT = {"zero": (PROMPTS, dict(max_tokens=0)), "neg": (PROMPTS, dict(max_tokens=-1)),
            "full": ([[3] * 60, [5, 6, 7], [9] * 20, [11, 12]], dict(max_tokens=4))}


def _jax_gpt2(name, eos=9):
    _, kw, tree = MODELS[name]
    JaxGPT2.vocab_size, JaxGPT2.max_seq_len = 128, 128
    try:
        m = JaxGPT2(4, kw["d_model"], rng=kw["rng"])
    finally:
        JaxGPT2.vocab_size, JaxGPT2.max_seq_len = 50257, 1024
    m.params = jax.tree.map(jnp.asarray, tree)
    return m


def _eos_id():
    """The 5th generated token of the first prompt's stream: an EOS that stops it early."""
    return DecoderGenerator(build(MODELS["gpt2_256_l4"]), Tok()).generate_tokens_batch([[5, 6, 7]], 12)[0][3 + 4]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, by world size (2, 4, 8), each a list over the ranks."""
    c = {"prompts": PROMPTS, "eos_prompts": EOS_PROMPTS, "eos": _eos_id(), "tp_pp": TP_PP, "ep_cfg": EP_CFG,
         "pp": {2: [("gpt2_128_l4", 2)], 4: [("gpt2_128_l4", 4)]}, "ep_prompts": EP_PROMPTS,
         "ep": {2: [("moe0", 2, EP_KW["moe0"])], 4: [("moe0", 4, EP_KW["moe0"]), ("moe1", 4, EP_KW["moe1"])]},
         "ep_short": {4: {label: ("moe0", 4, prompts, kw) for label, (prompts, kw) in EP_SHORT.items()}}}
    worlds = (2, 4, 8)
    got = run_ranks([(w, "pp_ep_serving", (MODELS, c)) for w in worlds], tmp_path_factory.mktemp("pp_ep"))
    return SimpleNamespace(eos=c["eos"], **{f"w{w}": r for w, r in zip(worlds, got)})


def _same_on_every_rank(results, key):
    for r, res in enumerate(results):
        assert res[key] == results[0][key], f"rank {r} parts from rank 0 on {key}"
    return results[0][key]


def _moves(rows, n_prompt):
    assert len({t for row, n in zip(rows, n_prompt) for t in row[n:]}) > 2


# ---- pp_serving.py ---------------------------------------------------------


@pytest.mark.parametrize("pp", [2, 4])
def test_pp_serving_matches_single_device(ranks, pp):
    ref = DecoderGenerator(build(MODELS["gpt2_128_l4"]), Tok()).generate_tokens_batch(PROMPTS, max_tokens=8)
    _moves(ref, [len(p) for p in PROMPTS])
    assert _same_on_every_rank(getattr(ranks, f"w{pp}"), f"pp{pp}") == ref
    jax_pp = JaxPP(_jax_gpt2("gpt2_128_l4"), Tok(), jax_make_mesh(pp, shape=(pp,), axes=("pp",)))
    assert jax_pp.generate_tokens_batch(PROMPTS, max_tokens=8) == ref


def test_pp_cache_memory_is_stage_local(ranks):
    """Each rank holds one stage of n_layers/pp layers (and makes caches for
    those alone); ``stage_stack`` cuts (n_stages, layers_per_stage)."""
    staged = stage_stack(build(MODELS["gpt2_128_l4"]).params, 2)
    assert [len(s) for s in staged["decoder"]["layers"]] == [2, 2]
    for pp, world in ((2, ranks.w2), (4, ranks.w4)):
        for res in world:
            assert res[f"pp{pp}_layers"] == [4 // pp]


# ---- tp_pp_serving.py ------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (2, 2), (2, 2, 2)], ids=str)
def test_tp_pp_serving_matches_single_device(ranks, shape):
    ref = DecoderGenerator(build(MODELS["gpt2_256_l4"]), Tok()).generate_tokens_batch(PROMPTS, max_tokens=8)
    _moves(ref, [len(p) for p in PROMPTS])
    assert _same_on_every_rank(ranks.w8 if np.prod(shape) == 8 else ranks.w4, shape) == ref
    axes = ("pp", "tp") if len(shape) == 2 else ("dp", "pp", "tp")
    jax_gen = JaxTPPP(_jax_gpt2("gpt2_256_l4"), Tok(), jax_make_mesh(int(np.prod(shape)), shape=shape, axes=axes))
    assert jax_gen.generate_tokens_batch(PROMPTS, max_tokens=8) == ref


def test_tp_pp_cache_and_param_sharding(ranks):
    """At (pp, tp) = (2, 4) a rank holds one stage of 2 layers, its quarter
    of q's columns and of o's rows, and the whole embedding table."""
    for res in ranks.w8:
        n_stages, n_layers, q, o, emb = res[((2, 4), "shards")]
        assert (n_stages, n_layers, q, o, emb) == (1, 2, (256, 64), (64, 256), (128, 256))


def test_tp_pp_eos_stops_early(ranks):
    ref = DecoderGenerator(build(MODELS["gpt2_256_l4"]), Tok(ranks.eos)).generate_tokens_batch(EOS_PROMPTS, 12)
    assert ref[0][-1] == ranks.eos and len(ref[0]) < 3 + 12  # stopped early
    assert _same_on_every_rank(ranks.w4, "tp_pp_eos") == ref
    jax_gen = JaxTPPP(_jax_gpt2("gpt2_256_l4"), Tok(ranks.eos), jax_make_mesh(4, shape=(2, 2), axes=("pp", "tp")))
    assert jax_gen.generate_tokens_batch(EOS_PROMPTS, max_tokens=12) == ref


# ---- ep_serving.py ---------------------------------------------------------


def _moe_ref(name):
    cfg = MoEDecoderConfig(**EP_CFG)
    return MoEDecoderGenerator(from_jax_params(MODELS[name]), cfg).generate_tokens_batch(EP_PROMPTS[name],
                                                                                         **EP_KW[name])


@pytest.mark.parametrize("ep", [2, 4])
def test_ep_serving_matches_single_device(ranks, ep):
    ref = _moe_ref("moe0")
    assert _same_on_every_rank(getattr(ranks, f"w{ep}"), ("moe0", ep)) == ref
    jax_params = jax.tree.map(jnp.asarray, MODELS["moe0"])
    jax_cfg = JaxMoECfg(**EP_CFG)
    assert JaxMoEGen(jax_params, jax_cfg).generate_tokens_batch(EP_PROMPTS["moe0"], **EP_KW["moe0"]) == ref
    jax_ep = JaxEP(jax_params, jax_cfg, jax_make_mesh(ep, shape=(ep,), axes=("ep",)))
    assert jax_ep.generate_tokens_batch(EP_PROMPTS["moe0"], **EP_KW["moe0"]) == ref


@pytest.mark.parametrize("ep", [2, 4])
def test_ep_serving_calls_all_to_all(ranks, ep):
    """Two all_to_alls per layer and forward (the prompts pad to 24 slots,
    8 new tokens: 8 forwards), over each rank's E/ep experts."""
    for res in getattr(ranks, f"w{ep}"):
        assert res[("moe0", ep, "all_to_all")] == 2 * EP_CFG["n_layers"] * 8
        assert res[("moe0", ep, "w1")] == (4 // ep, 128, 256)


def test_ep_serving_eos_lockstep(ranks):
    """Rows finish at different steps on different ranks: the loop runs on
    the all-reduced count of finished rows, so no rank leaves the others
    waiting in an all_to_all, and the tokens equal the single device's."""
    ref = _moe_ref("moe1")
    assert ref[4][-1] == ref[5][-1] == 239 and len(ref[4]) == len(ref[5]) < 2 + 12
    assert all(len(row) == 2 + 12 for i, row in enumerate(ref) if i not in (4, 5))
    assert _same_on_every_rank(ranks.w4, ("moe1", 4)) == ref
    jax_ep = JaxEP(jax.tree.map(jnp.asarray, MODELS["moe1"]), JaxMoECfg(**EP_CFG),
                   jax_make_mesh(4, shape=(4,), axes=("ep",)))
    assert jax_ep.generate_tokens_batch(EP_PROMPTS["moe1"], **EP_KW["moe1"]) == ref


@pytest.mark.parametrize("label", list(EP_SHORT))
def test_moe_generators_stop_as_jax_at_no_new_tokens(ranks, label):
    """JAX's MoE generators write the prefill's argmax before their loop
    tests the limit, so ``max_tokens`` 0 or -1 returns each prompt and one
    token; a prompt whose bucket fills the context leaves no slot for it,
    and JAX's raise a ValueError (an argmax over no generated column). The
    port's dense generator returns JAX's rows, or raises where JAX's do, and
    the EP generator at ep=4 does as the dense one."""
    prompts, kw = EP_SHORT[label]
    jax_gen = JaxMoEGen(jax.tree.map(jnp.asarray, MODELS["moe0"]), JaxMoECfg(**EP_CFG))
    gen = MoEDecoderGenerator(from_jax_params(MODELS["moe0"]), MoEDecoderConfig(**EP_CFG))
    if label == "full":
        with pytest.raises(ValueError):
            jax_gen.generate_tokens_batch(prompts, **kw)
        with pytest.raises(ValueError, match="no slot for a new token") as err:
            gen.generate_tokens_batch(prompts, **kw)
        assert _same_on_every_rank(ranks.w4, ("short", label)) == repr(err.value)
        return
    ref = gen.generate_tokens_batch(prompts, **kw)
    assert ref == jax_gen.generate_tokens_batch(prompts, **kw)
    assert [len(row) for row in ref] == [len(p) + 1 for p in prompts]
    assert all(row[:len(p)] == p for row, p in zip(ref, prompts))
    assert _same_on_every_rank(ranks.w4, ("short", label)) == ref


def test_moe_decoder_carriers_round_trip():
    back = to_jax_params(from_jax_params(MODELS["moe0"]))
    jax.tree.map(np.testing.assert_array_equal, back, MODELS["moe0"])


def test_moe_decoder_init_defaults_to_the_card():
    """``moe_decoder_init`` puts the parameters on the CUDA card unless
    asked for the CPU (without one it raises), so ``MoEDecoderGenerator``,
    which runs where its parameters lie, serves on the card by default."""
    from pytorch_models_tpu_torch.parallel.ep_serving import moe_decoder_init

    cfg = MoEDecoderConfig(**EP_CFG)
    gen = torch.Generator().manual_seed(0)
    cpu = moe_decoder_init(gen, cfg, device="cpu")
    assert cpu["layers"][1]["w2"].device == torch.device("cpu")
    if torch.cuda.is_available():
        assert moe_decoder_init(gen, cfg)["token_embs"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            moe_decoder_init(gen, cfg)
