"""``pretrained=True`` of Whisper and the wav2vec2 family (wav2vec2 /
HuBERT, SEW, data2vec-audio) in the PyTorch port vs the JAX package, on the
CPU (EnCodec's: tests/test_torch_pretrained_encodec.py).

One cache (``$PYTORCH_MODELS_TPU_CACHE``, a temporary directory) is filled
once for the module with synthetic checkpoints in each source's format,
under the file names both packages give them: OpenAI's Whisper ``.pt``
(``"model_state_dict"``) and HF ``.bin`` files (the wav2vec2 family, keys
under ``wav2vec2.``, which both loaders strip). The same ``from_*(tag,
pretrained=True)`` of both packages reads the same file: the port's
parameters must equal ``from_jax_params`` of JAX's bit for bit. Whisper-tiny
loads at its published size; the wav2vec2 family takes a small ``config``
dict (or fetches it: a fake ``requests`` answer), and each runs one forward
within its family's bound (tests/test_torch_whisper.py,
tests/test_torch_audio.py). Nothing is fetched.
"""

import json

import numpy as np
import pytest
import torch

import pytorch_models_tpu.models.audio as jax_audio
import pytorch_models_tpu.models.audio2text as jax_a2t
from pytorch_models_tpu_torch import audio
from pytorch_models_tpu_torch.audio2text import Whisper
from pytorch_models_tpu_torch.utils import from_jax_params
from tests.audio.test_wav2vec2 import _make_w2v2_sd
from tests.audio2text.test_whisper import _make_openai_sd
from tests.torch_pretrained_cache import assert_trees_equal, cache_file, np_tree, offline, write_torch

torch.set_num_threads(1)

WHISPER_TINY = dict(vocab_size=51865, n_layers=4, d_model=384, n_mels=80)
WHISPER_TINY_URL_HASH = "65147644a518d12f04e32d6f3b26facc3f8dd46e5390956a9424a650c0ce22b9"
ENC_TOL = 1e-4  # Whisper's encoder, tests/test_torch_whisper.py
W2V_MAX_TOL, W2V_MEAN_TOL = 2e-5, 2e-6  # tests/test_torch_audio.py

# tag -> (class, its config.json's keys from_hf reads, _make_w2v2_sd's kwargs)
W2V_TAGS = {
    "facebook/wav2vec2-base": ("Wav2Vec2", {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 1,
                                            "conv_bias": False, "feat_extract_norm": "group",
                                            "do_stable_layer_norm": False}, dict(stem_bias=False, legacy=True)),
    "facebook/hubert-large-ll60k": ("Wav2Vec2", {"num_hidden_layers": 2, "hidden_size": 128,
                                                 "num_attention_heads": 2, "conv_bias": True,
                                                 "feat_extract_norm": "layer", "do_stable_layer_norm": True},
                                    dict(stem_bias=True, legacy=False)),
    "asapp/sew-tiny-100k": ("SEW", {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 1,
                                    "conv_bias": False}, dict(stem_bias=False, legacy=True, proj_key="sew")),
    "facebook/data2vec-audio-base": ("Data2VecAudio", {"num_hidden_layers": 2, "hidden_size": 64,
                                                       "num_attention_heads": 1, "conv_bias": True},
                                     dict(stem_bias=True)),
}


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("audio_cache")
    r = np.random.default_rng(43)
    write_torch(cache_file(root, "tiny.pt"),
                {"dims": {"n_mels": 80, "n_audio_layer": 4}, "model_state_dict": _make_openai_sd(r, **WHISPER_TINY)})
    for tag, (name, config, ckpt_kw) in W2V_TAGS.items():
        sd = _make_w2v2_sd(r, getattr(jax_audio, name), config["num_hidden_layers"], config["hidden_size"],
                           **ckpt_kw)
        write_torch(cache_file(root, tag.replace("/", "_") + ".bin"), {f"wav2vec2.{k}": v for k, v in sd.items()})
    return root


def test_whisper_from_openai_pretrained_matches_jax(cache, monkeypatch):
    """Whisper-tiny at its published size: the params, then the encoder on one
    30 s segment's log-mel frames."""
    assert WHISPER_TINY_URL_HASH in jax_a2t.whisper.VARIANTS["tiny"]
    offline(monkeypatch, cache)
    ours = Whisper.from_openai("tiny", pretrained=True, device="cpu")
    ref = jax_a2t.Whisper.from_openai("tiny", pretrained=True)
    assert all(getattr(ours.cfg, k) == getattr(ref.cfg, k) for k in ("vocab_size", "n_layers", "d_model", "n_mels"))
    assert_trees_equal(ours.params, from_jax_params(np_tree(ref.params)))
    mel = np.random.default_rng(47).standard_normal((1, 80, 3000)).astype(np.float32)
    np.testing.assert_allclose(ours.encode(mel).numpy(), np.asarray(ref.encode(mel)), rtol=0, atol=ENC_TOL)


def _assert_w2v_forward(ours, ref):
    x = np.random.default_rng(53).standard_normal((1, 4000)).astype(np.float32)
    diff = np.abs(ours(x).numpy() - np.asarray(ref(x)))
    assert diff.max() < W2V_MAX_TOL and diff.mean() < W2V_MEAN_TOL, (diff.max(), diff.mean())


@pytest.mark.parametrize("tag", list(W2V_TAGS))
def test_wav2vec2_family_from_hf_pretrained_matches_jax(tag, cache, monkeypatch):
    offline(monkeypatch, cache)
    name, config, _ = W2V_TAGS[tag]
    ours = getattr(audio, name).from_hf(tag, pretrained=True, config=config, device="cpu")
    ref = getattr(jax_audio, name).from_hf(tag, pretrained=True, config=config)
    assert type(ours).__name__ == name and ours.cfg.__dict__ == ref.cfg.__dict__
    assert_trees_equal(ours.params, from_jax_params(np_tree(ref.params)))
    _assert_w2v_forward(ours, ref)


class _ConfigResponse:
    def __init__(self, config):
        self.ok, self.content = True, json.dumps(config).encode()


def test_wav2vec2_from_hf_fetches_its_config_as_jax_does(cache, monkeypatch):
    """Without a config both packages GET ``{tag}/raw/main/config.json``
    (uncached) and build the same model from it."""
    import requests

    offline(monkeypatch, cache)
    tag = "facebook/hubert-large-ll60k"
    asked = []

    def get(url, timeout=None):
        asked.append(url)
        return _ConfigResponse(W2V_TAGS[tag][1])

    monkeypatch.setattr(requests, "get", get)
    ours = audio.Wav2Vec2.from_hf(tag, pretrained=True, device="cpu")
    ref = jax_audio.Wav2Vec2.from_hf(tag, pretrained=True)
    assert asked == [f"https://huggingface.co/{tag}/raw/main/config.json"] * 2
    assert ours.cfg.__dict__ == ref.cfg.__dict__
    assert_trees_equal(ours.params, from_jax_params(np_tree(ref.params)))

