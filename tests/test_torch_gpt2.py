"""The GPT-2 serving slice of the PyTorch port vs the JAX package, on the CPU.

A small GPT-2 (2 layers, d_model 128, 2 heads, vocab 300, context 128) is
loaded in the JAX package from a synthetic HF state dict made with
``numpy.random.default_rng``; its parameters pass through
``from_jax_params`` into the port. On the CPU the JAX side runs its XLA
paths (no TPU: gather.py:130, attention.py:140,155), so this holds the
port's plain path — and, with the dispatch flags forced on, the kernels'
plain versions behind their wrappers — against the reference.
"""

import jax
import numpy as np
import pytest
import torch

import pytorch_models_tpu.models.text as jax_text
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.models.text import GPT2, DecoderGenerator
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.ops import gather
from pytorch_models_tpu_torch.utils import from_jax_params

torch.set_num_threads(1)

VOCAB, CTX, N_LAYERS, D = 300, 128, 2, 128
# fp32 on both sides: logits of order 1 after 2 layers; the two frameworks
# sum in different orders, which moves them by ~1e-6. 1e-4 leaves margin.
FP32_TOL = 1e-4
PROMPTS = [[5, 6, 7], [9] * 40, [11, 12], list(range(20, 41))]


class Tok:
    def __init__(self, eos=None):
        self.eos_token_id = eos

    def encode(self, s):
        return [int(c) + 1 for c in s]

    def decode(self, ts):
        return ts


def _hf_state_dict(seed=7):
    r = np.random.default_rng(seed)

    def rn(*shape, s=0.02):
        return (r.standard_normal(shape) * s).astype(np.float32)

    # token embeddings at scale 0.5 so the tied logits separate and greedy
    # paths are not decided by near-ties
    sd = {"wte.weight": rn(VOCAB, D, s=0.5), "wpe.weight": rn(CTX, D),
          "ln_f.weight": 1 + rn(D), "ln_f.bias": rn(D)}
    for i in range(N_LAYERS):
        p = f"h.{i}"
        sd |= {f"{p}.ln_1.weight": 1 + rn(D), f"{p}.ln_1.bias": rn(D),
               f"{p}.ln_2.weight": 1 + rn(D), f"{p}.ln_2.bias": rn(D),
               f"{p}.attn.c_attn.weight": rn(D, 3 * D, s=0.1), f"{p}.attn.c_attn.bias": rn(3 * D),
               f"{p}.attn.c_proj.weight": rn(D, D), f"{p}.attn.c_proj.bias": rn(D),
               f"{p}.mlp.c_fc.weight": rn(D, 4 * D), f"{p}.mlp.c_fc.bias": rn(4 * D),
               f"{p}.mlp.c_proj.weight": rn(4 * D, D), f"{p}.mlp.c_proj.bias": rn(D)}
    return sd


def _small(cls, **kw):
    old = (cls.vocab_size, cls.max_seq_len)
    cls.vocab_size, cls.max_seq_len = VOCAB, CTX
    try:
        return cls(N_LAYERS, D, **kw)
    finally:
        cls.vocab_size, cls.max_seq_len = old


@pytest.fixture(scope="module")
def models():
    ref = _small(jax_text.GPT2)
    ref.load_hf_state_dict(_hf_state_dict())
    ours = _small(GPT2, device="cpu")
    ours.params = from_jax_params(jax.tree.map(to_np, ref.params))
    return ref, ours


@pytest.fixture(params=["plain", "kernel_wrappers"])
def flags(request):
    """"plain": every dispatch flag False (the JAX package's XLA route).
    "kernel_wrappers": every flag True — on CPU tensors the wrappers run
    their kernels' plain versions, so this covers the kernel dispatch."""
    on = request.param == "kernel_wrappers"
    saved = (attn.USE_DECODE_KERNEL, attn.USE_ENCODER_KERNEL, attn.USE_GREEDY_HEAD, gather.USE_GATHER_KERNEL)
    attn.USE_DECODE_KERNEL = attn.USE_ENCODER_KERNEL = attn.USE_GREEDY_HEAD = gather.USE_GATHER_KERNEL = on
    yield request.param
    attn.USE_DECODE_KERNEL, attn.USE_ENCODER_KERNEL, attn.USE_GREEDY_HEAD, gather.USE_GATHER_KERNEL = saved


@pytest.fixture(scope="module")
def jax_outputs(models):
    ref, _ = models
    tokens = np.random.default_rng(3).integers(0, VOCAB, (2, 37))
    eos = 0
    plain = jax_text.DecoderGenerator(ref, Tok()).generate_tokens_batch(PROMPTS, max_tokens=12)
    # an EOS the model really emits mid-stream, so rows finish at different steps
    eos = plain[0][len(PROMPTS[0]) + 2]
    with_eos = jax_text.DecoderGenerator(ref, Tok(eos)).generate_tokens_batch(PROMPTS, max_tokens=12)
    single = [jax_text.DecoderGenerator(ref, Tok()).generate_tokens(p, max_tokens=9) for p in PROMPTS[:2]]
    seqs = [list(range(3, 60)), [7, 1, 4, 1, 5, 9, 2, 6] * 4]
    scores = jax_text.DecoderGenerator(ref, Tok()).score_tokens_batch(seqs)
    return {"tokens": tokens, "logits": np.asarray(ref(tokens)), "logits1": np.asarray(ref(tokens[0, :16])),
            "plain": plain, "eos": eos, "with_eos": with_eos, "single": single, "seqs": seqs, "scores": scores}


def test_from_jax_params_splits_layer_stack(models):
    ref, ours = models
    layers = ours.params["decoder"]["layers"]
    assert isinstance(layers, list) and len(layers) == N_LAYERS
    np.testing.assert_array_equal(layers[1]["sa"]["q"]["w"].numpy(),
                                  np.asarray(ref.params["decoder"]["layers"]["sa"]["q"]["w"][1]))


def test_logits_match_jax(models, jax_outputs, flags):
    _, ours = models
    got = ours(jax_outputs["tokens"])
    assert got.shape == (2, 37, VOCAB)
    np.testing.assert_allclose(got.numpy(), jax_outputs["logits"], atol=FP32_TOL, rtol=0)
    np.testing.assert_allclose(ours(jax_outputs["tokens"][0, :16]).numpy(), jax_outputs["logits1"],
                               atol=FP32_TOL, rtol=0)


def test_generate_tokens_batch_matches_jax(models, jax_outputs, flags):
    _, ours = models
    assert DecoderGenerator(ours, Tok()).generate_tokens_batch(PROMPTS, max_tokens=12) == jax_outputs["plain"]
    got = DecoderGenerator(ours, Tok(jax_outputs["eos"])).generate_tokens_batch(PROMPTS, max_tokens=12)
    assert got == jax_outputs["with_eos"]
    assert any(len(row) < len(p) + 12 for row, p in zip(got, PROMPTS))  # some row stopped at EOS


def test_generate_tokens_single_matches_jax(models, jax_outputs, flags):
    _, ours = models
    gen = DecoderGenerator(ours, Tok())
    assert [gen.generate_tokens(p, max_tokens=9) for p in PROMPTS[:2]] == jax_outputs["single"]


def test_score_tokens_batch_matches_jax(models, jax_outputs, flags):
    _, ours = models
    gen = DecoderGenerator(ours, Tok())
    got = gen.score_tokens_batch(jax_outputs["seqs"])
    for g, e in zip(got, jax_outputs["scores"]):
        assert len(g) == len(e)
        np.testing.assert_allclose(g, e, atol=FP32_TOL, rtol=0)
    ppl = gen.perplexity("3141")
    assert np.isfinite(ppl) and ppl > 0


def test_load_hf_state_dict_matches_jax(models):
    ref, _ = models
    ours = _small(GPT2, device="cpu")
    ours.load_hf_state_dict(_hf_state_dict())
    expected = from_jax_params(jax.tree.map(to_np, ref.params))
    flat_got = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), ours.params))
    flat_exp = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), expected)))
    assert len(flat_got) == len(flat_exp)
    for path, leaf in flat_got:
        np.testing.assert_array_equal(leaf, flat_exp[path])


def test_bf16_logits_match_jax(models, jax_outputs):
    ref, ours = models
    ref_bf16 = _small(jax_text.GPT2)
    ref_bf16.params = ref.params
    ref_bf16.to_bf16()
    ours_bf16 = _small(GPT2, device="cpu")
    ours_bf16.params = ours.params
    ours_bf16.to_bf16()
    tokens = jax_outputs["tokens"]
    expected = np.asarray(ref_bf16(tokens).astype(np.float32))
    got = ours_bf16(tokens).float().numpy()
    # bf16 keeps 8 significant bits (relative step 2^-8 = 0.4%); both sides
    # round at the same points (params, matmul outputs, bf16 scores), but
    # their fp32 accumulations differ in order, so a hidden value can land a
    # bf16 step or two apart, and that grows through 2 layers. A logit sums
    # 128 such values times embeddings of scale 0.5, so it moves by ~0.1
    # whatever its own size (the absolute floor), and large logits carry
    # their own rounding on top (3% relative is about 8 bf16 steps).
    np.testing.assert_allclose(got, expected, atol=0.15, rtol=0.03)
    assert (got.argmax(-1) == expected.argmax(-1)).mean() >= 0.95


def test_empty_token_lists_raise(models):
    _, ours = models
    gen = DecoderGenerator(ours, Tok())
    with pytest.raises(ValueError):
        gen.generate_tokens_batch([])
    with pytest.raises(ValueError):
        gen.score_tokens_batch([])


@pytest.mark.parametrize("make", ["gpt2", "whisper"])
def test_entry_points_default_to_the_card(make):
    """``device=None`` means the CUDA card: without one the constructor
    raises instead of landing on the CPU."""
    from pytorch_models_tpu_torch.audio2text import Whisper

    def build():
        return _small(GPT2) if make == "gpt2" else Whisper(100, 1, 64)

    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
