"""The port's public classes hold the JAX package's constructor surface.

For every public model class the port exports, ``__init__`` and each
``from_*`` constructor take the JAX class's parameters in the same order,
of the same kinds and with the same defaults; the one difference allowed is
a trailing ``device`` (the port's models run on the CUDA card unless the
caller asks for the CPU). Annotations are not compared.
"""

import inspect

import pytest

import pytorch_models_tpu.audio as jax_audio
import pytorch_models_tpu.audio2text as jax_a2t
import pytorch_models_tpu.image as jax_image
import pytorch_models_tpu.text as jax_text
from pytorch_models_tpu_torch import audio, audio2text, image, text
from tests.torch_pretrained_cache import offline

# (JAX namespace, the port's namespace, class name)
CLASSES = [(jax_text, text, n) for n in ("GPT", "GPT2", "BERT", "T5Model")] + [
    (jax_a2t, audio2text, "Whisper")] + [
    (jax_image, image, n) for n in ("ViT", "MLPMixer", "ConvNeXt", "MaxViT", "MobileViT", "DETR", "DETRPipeline")] + [
    (jax_audio, audio, n) for n in ("Wav2Vec2", "SEW", "Data2VecAudio", "EnCodec", "Spectrogram", "MelSpectrogram")]


def _constructors(cls) -> list[str]:
    return ["__init__"] + sorted(n for n in vars(cls) if n.startswith("from_"))


def _surface(fn) -> list[tuple]:
    return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("jax_ns,ns,name", CLASSES, ids=[c[2] for c in CLASSES])
def test_constructor_signatures_match_jax(jax_ns, ns, name):
    ref, ours = getattr(jax_ns, name), getattr(ns, name)
    assert _constructors(ours) == _constructors(ref)
    for method in _constructors(ref):
        got, expected = _surface(getattr(ours, method)), _surface(getattr(ref, method))
        if got and got[-1][0] == "device":
            assert got[-1][2] is None, f"{name}.{method}: device defaults to None (the CUDA card)"
            got = got[:-1]
        assert got == expected, f"{name}.{method}: {got} != {expected}"


# the parallel serving classes and the train step's constructor (parallel/), by module
PARALLEL = [("serving", n) for n in ("TPDecoderGenerator", "TPT5Generator", "TPWhisperGenerator")] + [
    ("cb_serving", n) for n in ("TPContinuousBatchingGenerator", "TPWhisperContinuousBatchingGenerator",
                                "TPT5ContinuousBatchingGenerator")] + [("spec_serving", "TPSpeculativeGenerator")] + [
    ("pp_serving", "PPDecoderGenerator"), ("tp_pp_serving", "TPPPDecoderGenerator")] + [
    ("ep_serving", n) for n in ("MoEDecoderGenerator", "EPMoEGenerator")] + [("train", "make_train_step")]


def _matches_with_trailing_device(got, expected, what):
    if got and got[-1][0] == "device":
        assert got[-1][2] is None, f"{what}: device defaults to None (the CUDA card)"
        got = got[:-1]
    assert got == expected, f"{what}: {got} != {expected}"


@pytest.mark.parametrize("module,name", PARALLEL, ids=[p[1] for p in PARALLEL])
def test_parallel_constructor_signatures_match_jax(module, name):
    import importlib

    ref = getattr(importlib.import_module(f"pytorch_models_tpu.parallel.{module}"), name)
    ours = getattr(importlib.import_module(f"pytorch_models_tpu_torch.parallel.{module}"), name)
    if inspect.isclass(ref):
        ref, ours, name = ref.__init__, ours.__init__, f"{name}.__init__"
    _matches_with_trailing_device(_surface(ours), _surface(ref), name)


def test_make_mesh_and_parallel_exports_match_jax():
    """``make_mesh`` takes the JAX package's arguments (ranks for devices)
    and a trailing ``device``; ``parallel`` exports the JAX package's names."""
    import pytorch_models_tpu.parallel as jax_parallel
    from pytorch_models_tpu_torch import parallel

    _matches_with_trailing_device(_surface(parallel.make_mesh), _surface(jax_parallel.make_mesh), "make_mesh")
    assert sorted(parallel.__all__) == sorted(jax_parallel.__all__)
    for name in parallel.__all__:
        assert getattr(parallel, name).__name__ == name


def test_every_family_is_exported_under_the_jax_names():
    assert sorted(image.__all__) == sorted(jax_image.__all__)
    assert sorted(audio.__all__) == sorted(jax_audio.__all__)
    for n in ("BERT", "GPT"):
        assert n in text.__all__ and getattr(text, n).__name__ == n
    assert set(text.__all__) <= set(jax_text.__all__)


def test_ops_export_the_convolutions():
    from pytorch_models_tpu_torch.ops import conv1d, conv2d
    from pytorch_models_tpu_torch.ops import layers

    assert conv1d is layers.conv1d and conv2d is layers.conv2d


def test_dropout_at_the_jax_position():
    """``dropout`` is accepted (and ignored) where the JAX constructors take
    it, so a third positional argument to GPT2 is dropout, not rng."""
    import torch

    a = text.GPT2(1, 64, 0.0, 5, device="cpu")
    b = text.GPT2(1, 64, rng=5, device="cpu")
    assert torch.equal(a.params["token_embs"], b.params["token_embs"])
    assert text.GPT2.from_hf("gpt2", dropout=0.0, device="cpu").cfg.n_layers == 12
    assert audio2text.Whisper.from_openai("tiny", dropout=0.0, device="cpu").cfg.d_model == 384


# asapp/sew-tiny-100k's config.json, the keys from_hf reads
SEW_TINY = {"num_hidden_layers": 12, "hidden_size": 256, "num_attention_heads": 4, "conv_bias": False}

# every from_* of the families this port added, with pretrained=True on an empty cache: the miss (and
# a missing config.json) goes to requests, which fails without a network
PRETRAINED = [
    lambda: text.GPT.from_openai(pretrained=True, n_layers=1, d_model=64, device="cpu"),
    lambda: text.BERT.from_hf("bert-base-uncased", pretrained=True, device="cpu"),
    lambda: text.BERT.from_hf("bert-base-uncased", pretrained=True, device="cpu",
                              config={"model_type": "bert", "vocab_size": 64, "num_hidden_layers": 1,
                                      "hidden_size": 64, "max_position_embeddings": 16, "layer_norm_eps": 1e-12}),
    lambda: image.MLPMixer.from_google("B/16", pretrained=True, device="cpu"),
    lambda: image.ConvNeXt.from_facebook("tiny", pretrained=True, device="cpu"),
    lambda: image.MaxViT.from_google("tiny", pretrained=True, device="cpu"),
    lambda: image.MobileViT.from_apple("s", pretrained=True, device="cpu"),
    lambda: image.DETR.from_facebook("resnet50", pretrained=True, device="cpu"),
    lambda: audio.Wav2Vec2.from_hf("facebook/wav2vec2-base", pretrained=True, device="cpu"),
    lambda: audio.SEW.from_hf("asapp/sew-tiny-100k", pretrained=True, device="cpu", config=SEW_TINY),
    lambda: audio.Data2VecAudio.from_hf("facebook/data2vec-audio-base", pretrained=True, device="cpu",
                                        config=dict(SEW_TINY, hidden_size=768, num_attention_heads=12)),
    lambda: audio.EnCodec.from_facebook("24khz", pretrained=True, device="cpu"),
]


@pytest.mark.parametrize("i", range(len(PRETRAINED)))
def test_pretrained_raises_without_touching_the_network(i, monkeypatch, tmp_path):
    """A cache miss asks ``requests`` (here: an unreachable host) and
    raises its error; no socket is opened."""
    import requests

    offline(monkeypatch, tmp_path)
    with pytest.raises(requests.ConnectionError):
        PRETRAINED[i]()


# the loading layer's functions, by module: the port's against the JAX package's
LOADING = [("utils.download", n) for n in ("cache_dir", "hub_download", "load_hf_checkpoint")] + [
    ("utils.tf_ckpt", "load_tf_checkpoint"), ("models.text.t5x_loader", "url_join"),
    ("models.text.t5x_loader", "get_checkpoint_location"), ("models.text.t5x_loader", "load_t5x_checkpoint")]


@pytest.mark.parametrize("module,name", LOADING, ids=[f"{m}.{n}" for m, n in LOADING])
def test_loading_functions_match_jax(module, name):
    import importlib

    ref = getattr(importlib.import_module(f"pytorch_models_tpu.{module}"), name)
    ours = getattr(importlib.import_module(f"pytorch_models_tpu_torch.{module}"), name)
    assert _surface(ours) == _surface(ref), f"{module}.{name}"


def test_checkpoint_reader_save_load_and_tokenizers_match_jax():
    """``load_torch_checkpoint`` (the JAX package's lives in
    ``utils/torch_ckpt.py``, the port's in ``utils/checkpoint.py``), the TF
    reader's methods, ``InferenceModel.save`` / ``load`` and both
    tokenizers' ``from_openai``; ``utils`` exports ``hub_download``."""
    import pytorch_models_tpu.models.audio2text.tokenizer as jax_wtok
    import pytorch_models_tpu.models.text.tokenizer as jax_gtok
    import pytorch_models_tpu.utils as jax_utils
    import pytorch_models_tpu.utils.module as jax_module
    import pytorch_models_tpu.utils.tf_ckpt as jax_tf_ckpt
    import pytorch_models_tpu.utils.torch_ckpt as jax_torch_ckpt
    from pytorch_models_tpu_torch import utils
    from pytorch_models_tpu_torch.models.audio2text import tokenizer as wtok
    from pytorch_models_tpu_torch.models.text import tokenizer as gtok
    from pytorch_models_tpu_torch.utils import checkpoint, module, tf_ckpt

    pairs = [(checkpoint.load_torch_checkpoint, jax_torch_ckpt.load_torch_checkpoint),
             (module.InferenceModel.save, jax_module.InferenceModel.save),
             (module.InferenceModel.load, jax_module.InferenceModel.load),
             (gtok.GPT2Tokenizer.from_openai, jax_gtok.GPT2Tokenizer.from_openai),
             (wtok.WhisperTokenizer.from_openai, jax_wtok.WhisperTokenizer.from_openai)]
    pairs += [(getattr(tf_ckpt.TFCheckpointReader, n), getattr(jax_tf_ckpt.TFCheckpointReader, n))
              for n in ("__init__", "get_variable_to_shape_map", "get_variable_to_dtype_map", "has_tensor",
                        "get_tensor", "close")]
    for ours, ref in pairs:
        assert _surface(ours) == _surface(ref), ours.__qualname__
    assert utils.hub_download is utils.download.hub_download and "hub_download" in utils.__all__
    assert "hub_download" in jax_utils.__all__
