"""GPT-1 through the PyTorch port vs the JAX package, on the CPU.

A small GPT-1 (2 layers, d_model 64, vocab and context 128) loads one
synthetic OpenAI checkpoint (``params_shapes.json``'s list of shapes and the
flat parameters cut into 10 shards, made by the JAX package's own test
helper from a numpy seed) in the JAX package; its params pass through
``from_jax_params`` into the port. The port's own loader takes the same
shards and must give the same params, bit for bit.

Tolerances: logits within PARITY.md's 1e-5 (fp32 on both sides, summed in
other orders: about 1e-7 relative per op); greedy tokens identical. GPT-1
is post-norm, so the port decodes it per-op even with the fused step
forced on; with every kernel flag forced on, the decode attention, the
embedding kernel and the tied greedy head run their plain twins behind
their wrappers, the route the card takes.
"""

import jax
import numpy as np
import pytest
import torch

import pytorch_models_tpu.models.text as jax_text
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.models.text import GPT, DecoderGenerator
from pytorch_models_tpu_torch.models.text._decoder_lm import decoder_lm_fused_ok
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.ops import gather
from pytorch_models_tpu_torch.utils import from_jax_params
from tests.test_torch_image_families import _assert_trees_equal
from tests.text.test_gpt import _make_openai_params

torch.set_num_threads(1)

VOCAB, CTX, N_LAYERS, D = 128, 128, 2, 64
TOL = 1e-5
PROMPTS = [[5, 6, 7], [9] * 20, [11, 12], list(range(20, 41))]


class Tok:
    eos_token_id = None

    def encode(self, s):
        return [int(c) + 1 for c in s]

    def decode(self, ts):
        return "".join(str(t - 1) for t in ts)


@pytest.fixture(scope="module")
def shards():
    params = _make_openai_params(np.random.default_rng(51), N_LAYERS, D, VOCAB, CTX)
    flat = np.concatenate([p.reshape(-1) for p in params])
    return [list(p.shape) for p in params], np.array_split(flat, 10)


@pytest.fixture(scope="module")
def models(shards):
    saved = [(cls, cls.vocab_size, cls.max_seq_len) for cls in (jax_text.GPT, GPT)]
    for cls, _, _ in saved:
        cls.vocab_size, cls.max_seq_len = VOCAB, CTX
    try:
        ref = jax_text.GPT(N_LAYERS, D)
        ref.load_openai_params(*shards)
        ours = GPT(N_LAYERS, D, device="cpu")
        loaded = GPT(N_LAYERS, D, device="cpu")
    finally:
        for cls, v, c in saved:
            cls.vocab_size, cls.max_seq_len = v, c
    ours.params = from_jax_params(jax.tree.map(to_np, ref.params))
    loaded.load_openai_params(*shards)
    return ref, ours, loaded


@pytest.fixture()
def kernel_route():
    """Every kernel wrapper forced on (on CPU tensors: their plain twins) and
    the fused step forced on too, which GPT-1's post-norm stack refuses."""
    saved = (attn.USE_DECODE_KERNEL, attn.USE_ENCODER_KERNEL, attn.USE_GREEDY_HEAD, attn.USE_FUSED_STEP,
             gather.USE_GATHER_KERNEL)
    attn.USE_DECODE_KERNEL = attn.USE_ENCODER_KERNEL = attn.USE_GREEDY_HEAD = attn.USE_FUSED_STEP = True
    gather.USE_GATHER_KERNEL = True
    yield
    (attn.USE_DECODE_KERNEL, attn.USE_ENCODER_KERNEL, attn.USE_GREEDY_HEAD, attn.USE_FUSED_STEP,
     gather.USE_GATHER_KERNEL) = saved


def test_config_matches_jax(models):
    ref, ours, _ = models
    assert ours.cfg.__dict__ == {k: getattr(ref.cfg, k) for k in ours.cfg.__dict__}
    assert (GPT.vocab_size, GPT.max_seq_len) == (jax_text.GPT.vocab_size, jax_text.GPT.max_seq_len) == (40478, 512)
    assert not ours.cfg.pre_norm and not ours.cfg.final_norm and ours.cfg.act == "approximate_gelu"


def test_loader_matches_jax(models):
    _, ours, loaded = models
    _assert_trees_equal(loaded.params, ours.params)


@pytest.mark.parametrize("route", ["sdpa", "kernels"])
@pytest.mark.parametrize("batched", [False, True])
def test_forward_matches_jax(models, route, batched, request):
    if route == "kernels":
        request.getfixturevalue("kernel_route")
    ref, ours, _ = models
    tokens = np.random.default_rng(52).integers(0, VOCAB, (2, 16) if batched else (16,))
    expected = np.asarray(ref(tokens))
    got = ours(tokens)
    assert got.shape == expected.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=TOL)


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_greedy_tokens_match_jax(models, route, request):
    """generate / generate_tokens / generate_tokens_batch, greedy, against
    the JAX package's DecoderGenerator on the same params."""
    ref, ours, _ = models
    if route == "kernels":
        request.getfixturevalue("kernel_route")
        assert not decoder_lm_fused_ok(ours.params, ours.cfg, len(PROMPTS))  # post-norm: per-op
    else:
        for flag in ("USE_DECODE_KERNEL", "USE_ENCODER_KERNEL", "USE_GREEDY_HEAD", "USE_FUSED_STEP"):
            assert getattr(attn, flag) is None
    jgen, gen = jax_text.DecoderGenerator(ref, Tok()), DecoderGenerator(ours, Tok())
    assert gen.generate("271828", max_tokens=15) == jgen.generate("271828", max_tokens=15)
    assert gen.generate_tokens(PROMPTS[0], max_tokens=12) == jgen.generate_tokens(PROMPTS[0], max_tokens=12)
    got = gen.generate_tokens_batch(PROMPTS, max_tokens=12)
    assert got == jgen.generate_tokens_batch(PROMPTS, max_tokens=12)
    assert len({t for row, p in zip(got, PROMPTS) for t in row[len(p):]}) >= 3  # the streams move
