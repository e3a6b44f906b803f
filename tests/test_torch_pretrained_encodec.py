"""``pretrained=True`` of EnCodec (24 kHz and 48 kHz) in the PyTorch port vs
the JAX package, on the CPU, at the published sizes.

One cache (``$PYTORCH_MODELS_TPU_CACHE``, a temporary directory) holds a
synthetic Facebook ``.th`` checkpoint of each variant under the file name
both packages give it, with the codebooks' training statistics
(``inited``, ``cluster_size``, ``embed_avg``) that both loaders drop. The
same ``EnCodec.from_facebook(variant, pretrained=True)`` of both packages
reads the same file: the port's parameters must equal ``from_jax_params``
of JAX's bit for bit. Nothing is fetched.
"""

import numpy as np
import pytest
import torch

import pytorch_models_tpu.models.audio as jax_audio
from pytorch_models_tpu_torch import audio
from pytorch_models_tpu_torch.utils import from_jax_params
from tests.audio.test_encodec import _make_fb_encodec_sd
from tests.torch_pretrained_cache import assert_trees_equal, cache_file, np_tree, offline, write_torch

torch.set_num_threads(1)

ENCODEC_FILES = {"24khz": "encodec_24khz-d7cc33bc.th", "48khz": "encodec_48khz-7e698e3e.th"}


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("encodec_cache")
    r = np.random.default_rng(59)
    for variant, name in ENCODEC_FILES.items():
        sd = _make_fb_encodec_sd(r, variant)
        for key in [k for k in sd if k.endswith("_codebook.embed")]:
            stem = key.removesuffix("embed")
            sd |= {stem + "inited": np.ones(1, np.float32), stem + "cluster_size": np.ones(1024, np.float32),
                   stem + "embed_avg": sd[key].copy()}
        write_torch(cache_file(root, name), sd)
    return root


@pytest.mark.parametrize("variant", list(ENCODEC_FILES))
def test_encodec_from_facebook_pretrained_matches_jax(variant, cache, monkeypatch):
    offline(monkeypatch, cache)
    ours = audio.EnCodec.from_facebook(variant, pretrained=True, device="cpu")
    ref = jax_audio.EnCodec.from_facebook(variant, pretrained=True)
    assert ours.cfg.__dict__ == ref.cfg.__dict__
    assert_trees_equal(ours.params, from_jax_params(np_tree(ref.params)))
