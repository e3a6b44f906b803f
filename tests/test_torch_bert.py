"""BERT / RoBERTa through the PyTorch port vs the JAX package, on the CPU.

Forward: JAX's init (its zero PE redrawn from a numpy seed) carried across
with ``from_jax_params``, the same tokens from ``numpy.random.default_rng``,
through ``ops.sdpa`` and, with ``USE_ENCODER_KERNEL = True``, through the
encoder-attention kernel's plain twin behind its wrapper (the route the
card takes). Converters: one synthetic HF state dict, BERT's and RoBERTa's
(made by the JAX package's own test helper), to both loaders; the port's
params must equal the JAX params carried across, bit for bit.

Tolerance: PARITY.md's 1e-5 max abs on the encoder's output, which its
post-norm LayerNorm keeps of order 1 (fp32 on both sides, summed in other
orders: about 1e-7 relative per op).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_models_tpu.models.text as jax_text
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.models.text import BERT
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.utils import from_jax_params
from tests.test_torch_image_families import _assert_trees_equal
from tests.text.test_bert import _make_hf_bert_state_dict

torch.set_num_threads(1)

TOL = 1e-5
TINY = dict(vocab_size=100, n_layers=2, d_model=64, max_seq_len=64)
CONFIG = {"model_type": "bert", "vocab_size": 30522, "num_hidden_layers": 12, "hidden_size": 768,
          "max_position_embeddings": 512, "layer_norm_eps": 1e-12}


@pytest.fixture()
def kernel_route():
    saved = attn.USE_ENCODER_KERNEL
    attn.USE_ENCODER_KERNEL = True
    yield
    attn.USE_ENCODER_KERNEL = saved


@pytest.mark.parametrize("route", ["sdpa", "encoder_attention"])
def test_forward_matches_jax(route, request):
    if route == "encoder_attention":
        request.getfixturevalue("kernel_route")
    ref = jax_text.BERT(**TINY)
    tree = jax.tree.map(to_np, ref.params)
    tree["pos_embs"] = 0.1 * np.random.default_rng(61).standard_normal(tree["pos_embs"].shape).astype(np.float32)
    ref.params = jax.tree.map(jnp.asarray, tree)
    ours = BERT(**TINY, device="cpu")
    assert ours.cfg.__dict__ == ref.cfg.__dict__ and ours.cfg.vocab_size == 128  # padded to a multiple of 64
    ours.params = from_jax_params(tree)
    tokens = np.random.default_rng(62).integers(0, 100, (2, 16))
    for t in (tokens, tokens[0]):  # batched and unbatched
        expected = np.asarray(ref(t))
        got = ours(t)
        assert got.shape == expected.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=TOL)


@pytest.mark.parametrize("roberta", [False, True])
def test_hf_loader_matches_jax(roberta):
    """BERT's state dict (its pooler and MLM head skipped), and RoBERTa's with
    the two offset PE rows that both loaders strip."""
    r = np.random.default_rng(63)
    sd = _make_hf_bert_state_dict(r, 100, 2, 64, 32, roberta=roberta)
    if not roberta:
        sd["bert.pooler.dense.weight"] = np.zeros((64, 64), np.float32)
        sd["bert.embeddings.position_ids"] = np.arange(32)[None]
    dims = dict(TINY, max_seq_len=32)
    ref = jax_text.BERT(**dims)
    ref.load_hf_state_dict(sd)
    ours = BERT(**dims, device="cpu")
    ours.load_hf_state_dict(sd)
    expected = from_jax_params(jax.tree.map(to_np, ref.params))
    # the vocab's pad rows 100-127 keep each side's own random init
    expected["token_embs"][100:] = ours.params["token_embs"][100:]
    _assert_trees_equal(ours.params, expected)
    tokens = r.integers(0, 100, (2, 8))
    np.testing.assert_allclose(ours(tokens).numpy(), np.asarray(ref(tokens)), rtol=0, atol=TOL)


@pytest.mark.parametrize("model_type", ["bert", "roberta"])
def test_from_hf_config_matches_jax(model_type, monkeypatch):
    """``from_hf`` with the config passed in, and without one: then both
    packages GET the tag's ``config.json`` (a fake ``requests`` answer here)."""
    import json

    import requests

    config = dict(CONFIG, model_type=model_type, num_hidden_layers=1, hidden_size=64, vocab_size=1000)
    ours = BERT.from_hf("bert-base-uncased", config=config, device="cpu")
    ref = jax_text.BERT.from_hf("bert-base-uncased", config=config)
    assert ours.cfg.__dict__ == ref.cfg.__dict__
    assert ours.cfg.max_seq_len == (510 if model_type == "roberta" else 512)
    asked = []

    class Response:
        ok, content = True, json.dumps(config).encode()

    monkeypatch.setattr(requests, "get", lambda url, timeout=None: asked.append(url) or Response())
    assert BERT.from_hf("bert-base-uncased", device="cpu").cfg.__dict__ == ref.cfg.__dict__
    assert asked == ["https://huggingface.co/bert-base-uncased/raw/main/config.json"]
