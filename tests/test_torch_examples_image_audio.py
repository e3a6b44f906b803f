"""The port's image and codec examples (``examples/torch_image_classify.py``,
``torch_encodec_roundtrip.py``) against the JAX package's, on the CPU.

Each JAX script runs as a script (``tests/torch_examples_run.py``) and
builds its own random model; the test builds the same one and hands its
parameters to the port's ``main(["--cpu"], model=...)``. The printed lines
must agree (the codes' dtype aside: int32 in JAX, int64 in the port).

ViT-B/16: both scripts cast to bf16 (``to_bf16()``) before their forwards,
and bf16 is not parity-checked (PARITY.md), so the 224 px features are held
to PARITY.md's fp32 bound (max abs 2e-5) in fp32, the same parameters' fp32
forward on both sides, and the bf16 features to the bf16 bound of
tests/test_torch_vit.py scaled from its two layers to ViT-B/16's twelve:
atol 6 x 0.05, rtol 2^-5. EnCodec: codes equal (no near-tie on this
input), the reconstruction within 1e-3.
"""

import numpy as np
import torch

from pytorch_models_tpu.audio import EnCodec as JaxEnCodec
from pytorch_models_tpu.image import ViT as JaxViT
from pytorch_models_tpu_torch.audio import EnCodec
from pytorch_models_tpu_torch.image import ViT
from tests.torch_examples_run import port_params, run_jax, run_port

torch.set_num_threads(1)

VIT_FP32_TOL = 2e-5  # PARITY.md, ViT (AugReg)
VIT_BF16_TOL = (6 * 0.05, 2.0 ** -5)  # atol, rtol
RECON_TOL = 1e-3


def test_image_classify_matches_jax(monkeypatch):
    g, lines = run_jax("image_classify", monkeypatch)
    ref = JaxViT.from_google("B/16_augreg")
    model = ViT.from_google("B/16_augreg", device="cpu")
    model.params = port_params(ref)
    imgs = np.random.default_rng(0).standard_normal((2, 3, 224, 224)).astype(np.float32)
    np.testing.assert_allclose(model(imgs).numpy(), np.asarray(ref(imgs)), rtol=0, atol=VIT_FP32_TOL)
    out, got = run_port("image_classify", model=model)
    assert got == lines
    want = np.asarray(g["feats"]).astype(np.float32)
    np.testing.assert_allclose(out["features"].float().numpy(), want, rtol=VIT_BF16_TOL[1], atol=VIT_BF16_TOL[0])
    assert tuple(out["features_448"].shape) == (2, 768)


def test_encodec_roundtrip_matches_jax(monkeypatch):
    g, lines = run_jax("encodec_roundtrip", monkeypatch)
    model = EnCodec.from_facebook("24khz", device="cpu")
    model.params = port_params(JaxEnCodec.from_facebook("24khz"))
    out, got = run_port("encodec_roundtrip", model=model)
    assert got[1:] == lines[1:] and got[0] == lines[0].replace("int32", "int64")
    np.testing.assert_array_equal(out["codes"].numpy(), np.asarray(g["codes"]))
    np.testing.assert_allclose(out["reconstruction"].numpy(), np.asarray(g["out"]), rtol=0, atol=RECON_TOL)
