"""The port's checkpoint-loading layer vs the JAX package's, on the CPU.

``utils/download.py`` (the cache, ``hub_download``, ``load_hf_checkpoint``
with its ``.safetensors`` fallback), ``utils/checkpoint.py`` (the
``torch.load`` read under the JAX reader's allowlist), ``utils/tf_ckpt.py``
(the TF bundle reader), ``models/text/t5x_loader.py`` (its miss path, from
a fake HTTP session serving msgpack / gzip zarr bytes built here),
``InferenceModel.save`` / ``load`` and both tokenizers' ``from_openai``.
Every file is synthetic and local (``tests/torch_pretrained_cache.py``);
nothing is fetched: the tests that must reach the network's code path get a
fake ``requests`` answer, and a socket connection fails the test.
"""

import argparse
import gzip
import itertools
import math
import pickle
import sys
import zipfile

import numpy as np
import pytest
import torch

import pytorch_models_tpu.utils.download as jax_download
import pytorch_models_tpu.utils.tf_ckpt as jax_tf_ckpt
import pytorch_models_tpu.utils.torch_ckpt as jax_torch_ckpt
from pytorch_models_tpu.models.audio2text.tokenizer import WhisperTokenizer as JaxWhisperTokenizer
from pytorch_models_tpu.models.text import t5x_loader as jax_t5x
from pytorch_models_tpu.models.text.tokenizer import GPT2Tokenizer as JaxGPT2Tokenizer
from pytorch_models_tpu_torch import utils
from pytorch_models_tpu_torch.audio2text import Whisper, WhisperTokenizer
from pytorch_models_tpu_torch.image import ViT
from pytorch_models_tpu_torch.models.text import t5x_loader
from pytorch_models_tpu_torch.text import GPT2, GPT2Tokenizer, T5Model
from pytorch_models_tpu_torch.utils import checkpoint, download, tf_ckpt
from tests.torch_pretrained_cache import (CACHE_ENV, assert_trees_equal, cache_file, offline, write_tf_bundle,
                                          write_tiktoken, write_torch)

torch.set_num_threads(1)

PACKAGES = {"jax": jax_download, "port": download}


class _Response:
    """What ``requests.get(url, stream=True)`` returns, from bytes or a status."""

    def __init__(self, status: int = 200, content: bytes = b""):
        self.status_code, self.content = status, content

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def raise_for_status(self):
        import requests

        if self.status_code >= 400:
            raise requests.HTTPError(f"{self.status_code}", response=self)

    def iter_content(self, chunk_size=1):
        for i in range(0, len(self.content), chunk_size):
            yield self.content[i:i + chunk_size]


def _serve(monkeypatch, files: dict[str, _Response]) -> list[str]:
    """``requests.get`` answers from ``files`` by URL (404 otherwise); returns the URLs asked for."""
    import requests

    asked = []

    def get(url, **kwargs):
        asked.append(url)
        return files.get(url, _Response(404))

    monkeypatch.setattr(requests, "get", get)
    return asked


# --------------------------------------------------------------------------- the cache and hub_download


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_hub_download_hit_imports_nothing(pkg, tmp_path, monkeypatch):
    """A cached file is returned as it is; ``requests`` is never imported
    (``sys.modules["requests"] = None`` makes any import of it fail)."""
    offline(monkeypatch, tmp_path)
    cache_file(tmp_path, "model.npz").write_bytes(b"cached")
    cache_file(tmp_path, "x.bin", "sub").write_bytes(b"named")
    monkeypatch.setitem(sys.modules, "requests", None)
    mod = PACKAGES[pkg]
    assert mod.hub_download("https://example.invalid/a/model.npz") == str(tmp_path / "model.npz")
    named = mod.hub_download("https://example.invalid/pytorch_model.bin/", "sub", "x.bin")
    assert named == str(tmp_path / "sub" / "x.bin")
    with pytest.raises(ImportError):  # a miss needs requests
        mod.hub_download("https://example.invalid/missing.npz")


def test_cache_dir_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv(CACHE_ENV, str(tmp_path / "c"))
    assert download.cache_dir() == jax_download.cache_dir() == tmp_path / "c"
    assert download.cache_dir("maxvit_tiny") == jax_download.cache_dir("maxvit_tiny") == tmp_path / "c" / "maxvit_tiny"
    assert (tmp_path / "c" / "maxvit_tiny").is_dir()
    monkeypatch.delenv(CACHE_ENV)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert download.cache_dir() == jax_download.cache_dir() == tmp_path / "home" / ".cache" / "pytorch_models_tpu"


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_hub_download_miss_writes_the_same_file(pkg, tmp_path, monkeypatch):
    """A miss streams the body through ``<name>.part`` into the cache; a
    failed one leaves no file that would read as a hit."""
    offline(monkeypatch, tmp_path)
    url = "https://example.invalid/whisper/assets/gpt2.tiktoken"
    asked = _serve(monkeypatch, {url: _Response(200, b"abc" * 1000)})
    mod = PACKAGES[pkg]
    path = mod.hub_download(url, "whisper_tokenizer")
    assert path == str(tmp_path / "whisper_tokenizer" / "gpt2.tiktoken") and asked == [url]
    assert open(path, "rb").read() == b"abc" * 1000
    assert sorted(p.name for p in (tmp_path / "whisper_tokenizer").iterdir()) == ["gpt2.tiktoken"]
    import requests

    with pytest.raises(requests.HTTPError):
        mod.hub_download("https://example.invalid/gone.pt")
    assert not (tmp_path / "gone.pt").exists()


def _hf_state_dict(seed=3):
    r = np.random.default_rng(seed)
    return {"wte.weight": r.standard_normal((7, 4)).astype(np.float32),
            "h.0.attn.bias": np.arange(6, dtype=np.int64), "ln_f.weight": r.standard_normal(4).astype(np.float16)}


def _assert_sd_equal(ours: dict, theirs: dict, expected: dict) -> None:
    assert set(ours) == set(theirs) == set(expected)
    for k, v in expected.items():
        assert ours[k].dtype == torch.from_numpy(v).dtype and torch.equal(ours[k], torch.from_numpy(v)), k
        np.testing.assert_array_equal(theirs[k], v)


def test_load_hf_checkpoint_bin_hit_matches_jax(tmp_path, monkeypatch):
    """A cached ``.bin`` is read by both; the port's hit imports no ``requests``
    (JAX's imports it before it looks at the cache)."""
    offline(monkeypatch, tmp_path)
    sd = _hf_state_dict()
    write_torch(cache_file(tmp_path, "openai-community_gpt2.bin"), sd)
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "requests", None)
        ours = download.load_hf_checkpoint("openai-community/gpt2")
    _assert_sd_equal(ours, jax_download.load_hf_checkpoint("openai-community/gpt2"), sd)


def test_load_hf_checkpoint_falls_back_to_safetensors_on_404(tmp_path, monkeypatch):
    """The ``.bin`` answers 404: both packages read the cached
    ``.safetensors`` instead (the port through ``safetensors.torch``)."""
    from safetensors.numpy import save_file

    offline(monkeypatch, tmp_path)
    sd = _hf_state_dict(4)
    save_file(sd, str(cache_file(tmp_path, "facebook_hubert-base-ls960.safetensors")))
    asked = _serve(monkeypatch, {})
    ours = download.load_hf_checkpoint("facebook/hubert-base-ls960")
    theirs = jax_download.load_hf_checkpoint("facebook/hubert-base-ls960")
    _assert_sd_equal(ours, theirs, sd)
    assert asked == ["https://huggingface.co/facebook/hubert-base-ls960/resolve/main/pytorch_model.bin"] * 2
    assert not (tmp_path / "facebook_hubert-base-ls960.bin").exists()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_load_hf_checkpoint_reraises_other_failures(pkg, tmp_path, monkeypatch):
    """Only a 404 falls back: a server error is raised, not masked."""
    import requests

    offline(monkeypatch, tmp_path)
    save_file = pytest.importorskip("safetensors.numpy").save_file
    save_file(_hf_state_dict(), str(cache_file(tmp_path, "gpt2.safetensors")))
    _serve(monkeypatch, {"https://huggingface.co/gpt2/resolve/main/pytorch_model.bin": _Response(503)})
    with pytest.raises(requests.HTTPError, match="503"):
        PACKAGES[pkg].load_hf_checkpoint("gpt2")


# --------------------------------------------------------------------------- the torch.load allowlist


def _zip_pickle(path, payload: bytes) -> None:
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("archive/data.pkl", payload)


class _Evil:
    def __reduce__(self):
        import os

        return (os.system, ("echo pwned",))


def test_namespace_checkpoint_loads_in_both(tmp_path):
    """DETR's checkpoints carry ``argparse.Namespace`` args beside the
    weights: plain ``weights_only=True`` refuses them; both readers load."""
    path = tmp_path / "detr.pth"
    w = torch.randn(3, 2)
    torch.save({"model": {"w": w}, "args": argparse.Namespace(lr=1e-4, backbone="resnet50"), "epoch": 7}, path)
    with pytest.raises(pickle.UnpicklingError):
        torch.load(path, weights_only=True)
    ours, theirs = checkpoint.load_torch_checkpoint(str(path)), jax_torch_ckpt.load_torch_checkpoint(str(path))
    assert torch.equal(ours["model"]["w"], w) and np.array_equal(theirs["model"]["w"], w.numpy())
    assert (ours["args"].lr, ours["args"].backbone, ours["epoch"]) == (theirs["args"].lr, "resnet50", 7)


@pytest.mark.parametrize("payload", ["posix.system", "_codecs.encode", "builtins.eval"])
def test_disallowed_globals_are_refused_by_both(payload, tmp_path):
    """A pickle naming a global off the JAX reader's allowlist raises in
    both, before anything runs: the ``os.system`` payload, and also
    ``_codecs.encode`` (protocol 2's bytes, which torch's weights-only
    unpickler alone would take)."""
    path = tmp_path / "bad.pth"
    if payload == "_codecs.encode":
        torch.save({"w": torch.ones(2), "raw": b"\x00\x01bytes"}, path)
        with zipfile.ZipFile(path) as zf:
            data = zf.read(next(n for n in zf.namelist() if n.endswith("data.pkl")))
    else:
        data = pickle.dumps({"w": _Evil() if payload == "posix.system" else eval}, protocol=4)
        _zip_pickle(path, data)
    assert tuple(payload.split(".")) in checkpoint.pickle_globals(data)
    for load in (checkpoint.load_torch_checkpoint, jax_torch_ckpt.load_torch_checkpoint):
        with pytest.raises(pickle.UnpicklingError, match="allowlist"):
            load(str(path))


def test_pickle_globals_follow_the_memo():
    """A ``STACK_GLOBAL`` whose module string is a memo reference (the second
    global of one module) is resolved, so it cannot slip past the check."""
    import os

    data = pickle.dumps([os.system, os.getcwd], protocol=4)
    assert b"getcwd" in data and data.count(b"posix") == 1
    assert checkpoint.pickle_globals(data) == [("posix", "system"), ("posix", "getcwd")]


def test_tensors_keep_their_dtypes(tmp_path):
    """The port reads tensors as saved (bf16 stays bf16; JAX's numpy reader
    widens it to fp32), strided ones included."""
    sd = {"f32": torch.randn(4, 3), "f16": torch.randn(2, 2).half(), "bf16": torch.randn(3, 5, dtype=torch.bfloat16),
          "i64": torch.arange(6), "t": torch.randn(4, 6).t(), "nested": {"s": torch.tensor(3.5)}}
    path = tmp_path / "d.pth"
    torch.save(sd, path)
    ours, theirs = checkpoint.load_torch_checkpoint(str(path)), jax_torch_ckpt.load_torch_checkpoint(str(path))
    for k in ("f32", "f16", "bf16", "i64", "t"):
        assert ours[k].dtype == sd[k].dtype and ours[k].device.type == "cpu" and torch.equal(ours[k], sd[k]), k
        np.testing.assert_array_equal(theirs[k], sd[k].float().numpy() if k == "bf16" else sd[k].numpy())
    assert float(ours["nested"]["s"]) == float(theirs["nested"]["s"]) == 3.5


# --------------------------------------------------------------------------- the TF bundle reader


def _bundle_tensors(seed=5):
    r = np.random.default_rng(seed)
    t = {f"maxvit/block_{i:02d}_{j:02d}/attention/kernel/ExponentialMovingAverage":
         r.standard_normal((4, 2, 8)).astype(np.float32) for i in range(6) for j in range(4)}
    t |= {"maxvit/stem/conv_0/kernel/ExponentialMovingAverage": r.standard_normal((3, 3, 3, 16)).astype(np.float32),
          "global_step": np.int64(92002).reshape(()), "big": r.standard_normal((256, 257)).astype(np.float32),
          "ids": np.arange(7, dtype=np.int32)}
    return t


def test_tf_reader_matches_jax_on_a_numpy_bundle(tmp_path):
    tensors = _bundle_tensors()
    prefix = str(tmp_path / "model.ckpt-92002")
    write_tf_bundle(prefix, tensors)
    ours, theirs = tf_ckpt.load_tf_checkpoint(prefix), jax_tf_ckpt.load_tf_checkpoint(prefix)
    assert isinstance(ours, tf_ckpt.TFCheckpointReader)
    assert ours.get_variable_to_shape_map() == theirs.get_variable_to_shape_map() == \
        {k: list(v.shape) for k, v in tensors.items()}
    assert ours.get_variable_to_dtype_map() == theirs.get_variable_to_dtype_map()
    for name, value in tensors.items():
        assert ours.has_tensor(name)
        got = ours.get_tensor(name)
        assert got.dtype == value.dtype
        np.testing.assert_array_equal(got, value)
        np.testing.assert_array_equal(got, theirs.get_tensor(name))
    assert not ours.has_tensor("missing")
    ours.close()
    theirs.close()


def test_tf_reader_matches_tensorflow(tmp_path):
    """Against TF's own reader: on a bundle TF wrote (enough variables for a
    multi-block index), and on the numpy-written bundle the other tests use."""
    tf = pytest.importorskip("tensorflow")
    tensors = _bundle_tensors(6)
    written = {k: v for k, v in tensors.items() if k not in ("global_step", "ids")}
    prefix = str(tmp_path / "tf" / "model.ckpt")
    with tf.compat.v1.Graph().as_default():
        variables = [tf.compat.v1.get_variable(n, initializer=tf.constant(v)) for n, v in written.items()]
        saver = tf.compat.v1.train.Saver(variables, max_to_keep=1)
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, prefix, write_meta_graph=False)
    numpy_prefix = str(tmp_path / "np_model.ckpt")
    write_tf_bundle(numpy_prefix, tensors)
    for pfx, names in ((prefix, written), (numpy_prefix, tensors)):
        oracle, ours = tf.train.load_checkpoint(pfx), tf_ckpt.load_tf_checkpoint(pfx)
        oracle_map = oracle.get_variable_to_shape_map()
        for name in names:
            assert ours.get_variable_to_shape_map()[name] == list(oracle_map[name]), name
            np.testing.assert_array_equal(ours.get_tensor(name), np.asarray(oracle.get_tensor(name)), err_msg=name)
        ours.close()


# --------------------------------------------------------------------------- the t5x reader's miss path


def _t5x_files(location: str, tree: dict, chunk: int = 3) -> dict[str, bytes]:
    """The bytes a t5x checkpoint's URLs serve: the msgpack index, where a
    leaf whose name ends in "kernel" is a TensorStore entry of gzip zarr
    chunks (edge chunks padded), any other an inline msgpack ExtType."""
    import msgpack

    files = {}

    def encode(node, prefix):
        out = {}
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = encode(v, key)
            elif k.endswith("kernel"):
                path = f"target.{key}"
                chunks = [min(chunk, s) for s in v.shape]
                n_chunks = [math.ceil(s / c) for s, c in zip(v.shape, chunks)]
                padded = np.zeros([n * c for n, c in zip(n_chunks, chunks)], np.float32)
                padded[tuple(slice(0, s) for s in v.shape)] = v
                for idx in itertools.product(*[range(n) for n in n_chunks]):
                    piece = padded[tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, chunks))]
                    files[t5x_loader.url_join(t5x_loader.BASE_URL, location, path, ".".join(map(str, idx)))] = \
                        gzip.compress(np.ascontiguousarray(piece).tobytes())
                out[k] = {"kvstore": {"path": path},
                          "metadata": {"shape": list(v.shape), "chunks": chunks, "dtype": "<f4"}}
            else:
                out[k] = msgpack.ExtType(1, msgpack.packb((list(v.shape), "<f4", v.tobytes())))
        return out

    index = {"optimizer": {"target": encode(tree, "")}, "state": {"step": 1}}
    files[t5x_loader.url_join(t5x_loader.BASE_URL, location, "checkpoint")] = msgpack.packb(index)
    return files


def _t5x_tree(seed=9):
    r = np.random.default_rng(seed)

    def rn(*shape):
        return r.standard_normal(shape).astype(np.float32)

    return {"token_embedder": {"embedding": rn(11, 4)},
            "encoder": {"layers_0": {"attention": {"query": {"kernel": rn(4, 5)}, "out": {"kernel": rn(7, 4)}},
                                     "pre_attention_layer_norm": {"scale": rn(4)}},
                        "relpos_bias": {"rel_embedding": rn(2, 32)}},
            "decoder": {"logits_dense": {"kernel": rn(4, 11)}}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out |= _flat(v, key) if isinstance(v, dict) else {key: v}
    return out


def test_t5x_miss_path_matches_jax(tmp_path, monkeypatch):
    """A miss reads the msgpack index, the inline ExtType tensors and the
    zarr chunks (reassembled by index, cut to shape) through a pooled HTTP
    session, and writes the ``.npz``; both packages give the same dict and
    the same file, and the next call reads the ``.npz`` without importing
    ``msgpack`` or ``requests``."""
    import requests

    offline(monkeypatch, tmp_path)
    assert t5x_loader.get_checkpoint_location("flan_t5", "base") == jax_t5x.get_checkpoint_location("flan_t5", "base")
    location = t5x_loader.get_checkpoint_location("flan_t5", "small")
    tree = _t5x_tree()
    files = _t5x_files(location, tree)
    asked = []

    class Session:
        def mount(self, prefix, adapter):
            assert prefix == t5x_loader.BASE_URL

        def get(self, url, timeout=None):
            asked.append(url)
            return _Response(200, files[url])

    monkeypatch.setattr(requests, "Session", Session)
    ours = t5x_loader.load_t5x_checkpoint(location, n_threads=2, cache=str(tmp_path / "ours"))
    theirs = jax_t5x.load_t5x_checkpoint(location, n_threads=2, cache=str(tmp_path / "theirs"))
    expected = _flat(tree)
    assert set(ours) == set(theirs) == set(expected)
    for k, v in expected.items():
        np.testing.assert_array_equal(ours[k], v)
        np.testing.assert_array_equal(theirs[k], v)
    assert sorted(asked) == sorted(list(files) * 2)
    name = location.replace("/", "_") + ".npz"
    ours_npz, theirs_npz = np.load(tmp_path / "ours" / name), np.load(tmp_path / "theirs" / name)
    assert set(ours_npz.files) == set(theirs_npz.files) == set(expected)
    for k in expected:
        np.testing.assert_array_equal(ours_npz[k], theirs_npz[k])
    monkeypatch.setitem(sys.modules, "msgpack", None)
    monkeypatch.setitem(sys.modules, "requests", None)
    again = t5x_loader.load_t5x_checkpoint(location, cache=str(tmp_path / "ours"))
    assert all(np.array_equal(again[k], v) for k, v in expected.items())


# --------------------------------------------------------------------------- save / load


def _models():
    return {"gpt2": lambda rng: GPT2(2, 64, rng=rng, device="cpu"),
            "whisper": lambda rng: Whisper(100, 2, 64, 80, rng=rng, device="cpu"),
            "t5": lambda rng: T5Model(100, 64, 2, 2, 128, rng=rng, device="cpu"),
            "vit": lambda rng: ViT(2, 64, 2, 16, img_size=64, rng=rng, device="cpu")}


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8", "int8_bf16"])
@pytest.mark.parametrize("model", list(_models()))
def test_save_load_round_trip(model, mode, tmp_path):
    """``save`` then ``load`` into a model of another seed restores the tree
    bit for bit: its lists, dtypes and int8 ``{"w_q", "w_s"}`` leaves."""
    make = _models()[model]
    m = make(0)
    if mode.startswith("int8"):
        m.quantize_int8()
    if mode.endswith("bf16"):
        m.to_bf16()
    path = tmp_path / f"{model}.pt"
    assert m.save(str(path)) is m
    other = make(1)
    assert other.load(str(path)) is other
    assert_trees_equal(other.params, m.params)
    leaves = []
    utils.tree_map(leaves.append, other.params)
    dtypes = {t.dtype for t in leaves}
    assert (torch.int8 in dtypes) == mode.startswith("int8")
    assert (torch.bfloat16 in dtypes) == mode.endswith("bf16")


# --------------------------------------------------------------------------- the tokenizers


def _ranks():
    ranks = {bytes([i]): i for i in range(256)}
    for tok in (b"he", b"ll", b"hell", b"lo", b" w", b"or"):
        ranks[tok] = len(ranks)
    return ranks


TEXTS = ["hello world", "hell's bells, or worse", "  café 東京 🙂\t\n"]


@pytest.mark.parametrize("which", ["gpt2", "whisper", "whisper.en"])
def test_tokenizers_from_openai_match_jax(which, tmp_path, monkeypatch):
    """``from_openai`` reads the cached ``.tiktoken`` (GPT-2's under
    ``gpt2_tokenizer/``, Whisper's under ``whisper_tokenizer/``) in both
    packages: the same table, special tokens and ids."""
    pytest.importorskip("tiktoken")
    offline(monkeypatch, tmp_path)
    subdir, name = {"gpt2": ("gpt2_tokenizer", "gpt2"), "whisper": ("whisper_tokenizer", "multilingual"),
                    "whisper.en": ("whisper_tokenizer", "gpt2")}[which]
    write_tiktoken(cache_file(tmp_path, f"{name}.tiktoken", subdir), _ranks())
    if which == "gpt2":
        ours, theirs = GPT2Tokenizer.from_openai(), JaxGPT2Tokenizer.from_openai()
    else:
        multilingual = which == "whisper"
        ours = WhisperTokenizer.from_openai(multilingual=multilingual, num_languages=100)
        theirs = JaxWhisperTokenizer.from_openai(multilingual=multilingual, num_languages=100)
        assert ours.sot_sequence("de", "translate") == theirs.sot_sequence("de", "translate")
    assert ours.ranks == theirs.ranks == _ranks()
    assert (ours.special_tokens, ours.n_vocab, ours.eos_token_id) == \
        (theirs.special_tokens, theirs.n_vocab, theirs.eos_token_id)
    for text in TEXTS:
        ids = ours.encode(text)
        assert ids == theirs.encode(text) and ours.decode(ids) == text
