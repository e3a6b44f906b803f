"""``pretrained=True`` of the text families (GPT-2, GPT-1, BERT / RoBERTa,
T5) in the PyTorch port vs the JAX package, on the CPU.

One cache (``$PYTORCH_MODELS_TPU_CACHE``, a temporary directory) is filled
once for the module with synthetic checkpoints in each source's format,
under the file names both packages give them: HF ``.bin`` files (GPT-2,
BERT, RoBERTa), OpenAI's ``params_shapes.json`` + 10 ``.npy`` shards
(GPT-1) and t5x's flattened ``.npz`` (T5, cached under ``checkpoints/`` in
the working directory). The same ``from_*(tag, pretrained=True)`` of both
packages reads the same file: the port's parameters must equal
``from_jax_params`` of JAX's bit for bit, and one forward agrees within the
family's tolerance of ``tests/test_torch_<family>.py``. Widths are cut where
the tag fixes them (the variant tables patched in both packages, the
vocabularies kept); nothing is fetched.
"""

import json

import numpy as np
import pytest
import torch

import pytorch_models_tpu.models.text as jax_text
import pytorch_models_tpu.models.text.gpt2 as jax_gpt2
import pytorch_models_tpu.models.text.t5 as jax_t5
import pytorch_models_tpu_torch.models.text.gpt2 as gpt2
import pytorch_models_tpu_torch.models.text.t5 as t5
from pytorch_models_tpu_torch.text import BERT, GPT, GPT2, T5Generator, T5Model
from pytorch_models_tpu_torch.utils import from_jax_params
from tests.text.test_bert import _make_hf_bert_state_dict
from tests.text.test_gpt import _make_openai_params
from tests.text.test_gpt2 import _make_hf_gpt2_state_dict
from tests.text.test_t5 import _make_t5x_flat
from tests.torch_pretrained_cache import assert_trees_equal, cache_file, np_tree, offline, write_torch

torch.set_num_threads(1)

N_LAYERS, D = 2, 64
BERT_VOCAB, BERT_LEN = 128, 64  # a multiple of 64: no pad rows, which keep each side's own init
T5_SMALL = (64, 2, 2, 128)  # (dim, n_heads, n_layers, mlp_dim) in place of t5 "small"'s
T5_LOCATION = "flan_t5_small/checkpoint_1198000"
# each family's fp32 bound against JAX (tests/test_torch_gpt2.py, test_torch_gpt.py, test_torch_bert.py,
# test_torch_t5.py)
GPT2_TOL, GPT_TOL, BERT_TOL, T5_TOL = 1e-4, 1e-5, 1e-5, 1e-4


def _bert_config(model_type="bert"):
    return {"model_type": model_type, "vocab_size": BERT_VOCAB, "num_hidden_layers": N_LAYERS, "hidden_size": D,
            "max_position_embeddings": BERT_LEN + (2 if model_type == "roberta" else 0), "layer_norm_eps": 1e-12}


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("text_cache")
    r = np.random.default_rng(19)
    write_torch(cache_file(root, "gpt2.bin"),
                _make_hf_gpt2_state_dict(r, GPT2.vocab_size, GPT2.max_seq_len, N_LAYERS, D))
    params = _make_openai_params(r, N_LAYERS, D, vocab=GPT.vocab_size, max_len=GPT.max_seq_len)
    cache_file(root, "params_shapes.json", "openai_gpt").write_text(json.dumps([list(p.shape) for p in params]))
    for i, shard in enumerate(np.array_split(np.concatenate([p.ravel() for p in params]), 10)):
        np.save(cache_file(root, f"params_{i}.npy", "openai_gpt"), shard)
    for name, roberta in (("bert-base-uncased", False), ("roberta-base", True), ("gaunernst_bert-tiny", False)):
        write_torch(cache_file(root, f"{name}.bin"),
                    _make_hf_bert_state_dict(r, BERT_VOCAB, N_LAYERS, D, BERT_LEN, roberta=roberta))
    dim, n_heads, n_layers, mlp_dim = T5_SMALL
    flat = _make_t5x_flat(r, dict(vocab_size=32128, dim=dim, n_heads=n_heads, n_layers=n_layers, mlp_dim=mlp_dim))
    np.savez(cache_file(root, T5_LOCATION.replace("/", "_") + ".npz", "checkpoints"), **flat)
    return root


def _tokens(vocab, shape, seed=23):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def test_gpt2_from_hf_pretrained_matches_jax(cache, monkeypatch):
    offline(monkeypatch, cache)
    for mod in (gpt2, jax_gpt2):  # GPT-2 small's tag, at 2 layers of width 64
        monkeypatch.setitem(mod.VARIANTS, "gpt2", (N_LAYERS, D))
    ours = GPT2.from_hf("gpt2", pretrained=True, device="cpu")
    ref = jax_text.GPT2.from_hf("gpt2", pretrained=True)
    assert_trees_equal(ours.params, from_jax_params(np_tree(ref.params)))
    x = _tokens(GPT2.vocab_size, (2, 16))
    np.testing.assert_allclose(ours(x).numpy(), np.asarray(ref(x)), rtol=0, atol=GPT2_TOL)


def test_gpt_from_openai_pretrained_matches_jax(cache, monkeypatch):
    offline(monkeypatch, cache)
    ours = GPT.from_openai(pretrained=True, n_layers=N_LAYERS, d_model=D, device="cpu")
    ref = jax_text.GPT.from_openai(pretrained=True, n_layers=N_LAYERS, d_model=D)
    assert_trees_equal(ours.params, from_jax_params(np_tree(ref.params)))
    x = _tokens(GPT.vocab_size, (2, 16))
    np.testing.assert_allclose(ours(x).numpy(), np.asarray(ref(x)), rtol=0, atol=GPT_TOL)


@pytest.mark.parametrize("tag,model_type", [("bert-base-uncased", "bert"), ("roberta-base", "roberta")])
def test_bert_from_hf_pretrained_matches_jax(tag, model_type, cache, monkeypatch):
    offline(monkeypatch, cache)
    ours = BERT.from_hf(tag, pretrained=True, config=_bert_config(model_type), device="cpu")
    ref = jax_text.BERT.from_hf(tag, pretrained=True, config=_bert_config(model_type))
    assert ours.cfg.__dict__ == ref.cfg.__dict__
    assert_trees_equal(ours.params, from_jax_params(np_tree(ref.params)))
    x = _tokens(BERT_VOCAB, (2, 16))
    np.testing.assert_allclose(ours(x).numpy(), np.asarray(ref(x)), rtol=0, atol=BERT_TOL)


class _ConfigResponse:
    def __init__(self, config):
        self.ok, self.content = config is not None, json.dumps(config).encode()


def test_bert_from_hf_fetches_its_config_as_jax_does(cache, monkeypatch):
    """Without a config both packages GET ``{tag}/raw/main/config.json``
    (uncached), then ``gaunernst/{tag}``'s, and read the checkpoint of the
    tag that answered."""
    import requests

    offline(monkeypatch, cache)
    asked = []

    def get(url, timeout=None):
        asked.append(url)
        return _ConfigResponse(_bert_config() if "/gaunernst/" in url else None)

    monkeypatch.setattr(requests, "get", get)
    ours = BERT.from_hf("bert-tiny", pretrained=True, device="cpu")
    ref = jax_text.BERT.from_hf("bert-tiny", pretrained=True)
    want = ["https://huggingface.co/bert-tiny/raw/main/config.json",
            "https://huggingface.co/gaunernst/bert-tiny/raw/main/config.json"]
    assert asked == want * 2
    assert_trees_equal(ours.params, from_jax_params(np_tree(ref.params)))
    monkeypatch.setattr(requests, "get", lambda url, timeout=None: _ConfigResponse(None))
    for cls in (BERT, jax_text.BERT):
        with pytest.raises(ValueError, match="Unsupported model"):
            cls.from_hf("no-such-model")


def _small_t5(monkeypatch, cache):
    offline(monkeypatch, cache)
    monkeypatch.chdir(cache)  # t5x's .npz cache is checkpoints/ under the working directory
    for mod in (t5, jax_t5):
        monkeypatch.setitem(mod.SIZES, "small", T5_SMALL)


def test_t5_from_t5x_pretrained_matches_jax(cache, monkeypatch):
    import sys

    _small_t5(monkeypatch, cache)
    monkeypatch.setitem(sys.modules, "msgpack", None)  # a cache hit reads the .npz alone
    ours = T5Model.from_t5x("flan_t5-small", pretrained=True, device="cpu")
    ref = jax_text.T5Model.from_t5x("flan_t5-small", pretrained=True)
    assert_trees_equal(ours.params, from_jax_params(np_tree(ref.params)))
    x, y = _tokens(32128, (2, 12)), _tokens(32128, (2, 7), seed=24)
    np.testing.assert_allclose(ours(x, y).numpy(), np.asarray(ref(x, y)), rtol=0, atol=T5_TOL)


def test_t5_generator_loads_its_tag_and_raises_only_at_the_tokenizer(cache, monkeypatch):
    """``T5Generator(tag)`` loads the model (on the CPU here, the card by
    default) and has no tokenizer: the string methods raise, the token
    methods run. (JAX's fetches a sentencepiece model the port does not.)"""
    _small_t5(monkeypatch, cache)
    monkeypatch.setattr(t5, "resolve_device", lambda device: torch.device("cpu"))
    gen = T5Generator("flan_t5-small")
    ref = jax_text.T5Model.from_t5x("flan_t5-small", pretrained=True)
    assert_trees_equal(gen.model.params, from_jax_params(np_tree(ref.params)))
    with pytest.raises(ValueError, match="tokenizer"):
        gen.generate("translate English to German: hello")
    out = gen.generate_tokens([5, 9, 13, 1], 4, 0, 1)
    assert out[0] == 0 and 1 <= len(out) <= 4
