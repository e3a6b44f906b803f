"""The log-mel frontend of the PyTorch port vs the JAX package, on the CPU.

The port's ``log_mel_spectrogram`` runs its plain version on CPU tensors
(the CUDA kernel needs the card: tests/test_torch_cuda.py). It is held
against the JAX Pallas kernel in interpret mode and against the JAX
package's XLA (rFFT) path, on waveforms made with
``numpy.random.default_rng`` that hold a stretch of exact silence, so both
the finite values and the -inf pattern of silent frames are compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pytorch_models_tpu.models.audio import MelSpectrogram as JaxMelSpectrogram
from pytorch_models_tpu.models.audio import spectrogram as jax_spec
from pytorch_models_tpu.models.audio2text import WhisperPreprocessor as JaxWhisperPreprocessor
from pytorch_models_tpu.ops import mel as jax_mel
from pytorch_models_tpu_torch.audio import MelSpectrogram, get_mel_filters
from pytorch_models_tpu_torch.models.audio import spectrogram
from pytorch_models_tpu_torch.models.audio2text import WhisperPreprocessor
from pytorch_models_tpu_torch.ops import mel

torch.set_num_threads(1)

# the bound of the JAX package's own kernel-vs-XLA test (tests/ops/test_mel.py)
TOL = 1e-4


def _waves(seed: int, b: int, n: int) -> np.ndarray:
    """Noise with a sine, and an exactly silent stretch of 0.25 s per row."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = 0.3 * r.standard_normal((b, n)) + 0.5 * np.sin(2 * np.pi * 440 * t)
    x[:, n // 3: n // 3 + 4000] = 0.0
    return x.astype(np.float32)


def _assert_logmel_close(got: np.ndarray, expected: np.ndarray) -> None:
    assert got.shape == expected.shape
    finite = np.isfinite(expected)
    assert (~finite).sum() > 0  # the silent stretch gives -inf frames
    np.testing.assert_array_equal(np.isfinite(got), finite)
    assert np.all(got[~finite] == -np.inf) and np.all(expected[~finite] == -np.inf)
    np.testing.assert_allclose(got[finite], expected[finite], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_constants_match_jax(n_mels):
    np.testing.assert_array_equal(get_mel_filters(n_mels, 400, 16000), jax_spec.get_mel_filters(n_mels, 400, 16000))
    np.testing.assert_array_equal(spectrogram.hann_window(400), jax_spec.hann_window(400))
    w_re, w_im, filt = mel._dft_constants(400, n_mels, 16000)
    j_re, j_im, j_filt = jax_mel._dft_constants(400, n_mels, 16000)  # padded to TPU tiles
    assert w_re.shape == (400, 201) and filt.shape == (201, n_mels)
    np.testing.assert_array_equal(w_re, j_re[:400, :201])
    np.testing.assert_array_equal(w_im, j_im[:400, :201])
    np.testing.assert_array_equal(filt, j_filt[:201, :n_mels])
    assert not j_re[400:].any() and not j_re[:, 201:].any() and not j_filt[201:].any()


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_plain_matches_jax_kernel_and_xla(n_mels):
    x = _waves(61, 2, 24000)
    got = mel.log_mel_spectrogram(torch.from_numpy(x), n_mels=n_mels).numpy()
    assert got.shape == (2, n_mels, 151)
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(jax_mel.log_mel_spectrogram(jnp.asarray(x), n_mels=n_mels))
    _assert_logmel_close(got, kernel)
    xla = np.asarray(jnp.log10(jnp.clip(JaxMelSpectrogram(400, 160, n_mels, 16000)(x), 0, None)))
    _assert_logmel_close(got, xla)
    # the port's own rFFT route (WhisperPreprocessor(fused=False)) vs JAX's
    rfft = torch.log10(MelSpectrogram(400, 160, n_mels, 16000)(torch.from_numpy(x)).clamp_min(0)).numpy()
    _assert_logmel_close(rfft, xla)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_bands_cover_exactly_the_nonzero_bins(n_mels):
    """The kernel's band table: each filter's [lo, hi) holds its nonzero
    weights and nothing else (contiguous, nonempty)."""
    filt = mel._dft_constants(400, n_mels, 16000)[2]
    bands = mel._mel_bands(filt)
    assert bands.shape == (n_mels, 2) and bands.dtype == np.int32
    for m, (lo, hi) in enumerate(bands.tolist()):
        assert 0 <= lo < hi <= filt.shape[0]
        assert np.all(filt[lo:hi, m] != 0) and not filt[:lo, m].any() and not filt[hi:, m].any()


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_banded_plain_matches_jax_kernel(n_mels):
    """The mel product over each filter's band only, as the CUDA kernel sums
    it, against the JAX kernel in interpret mode (the -inf frames included)."""
    x = _waves(65, 2, 24000)
    got = mel.log_mel_spectrogram_plain(torch.from_numpy(x), n_mels=n_mels, banded=True).numpy()
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(jax_mel.log_mel_spectrogram(jnp.asarray(x), n_mels=n_mels))
    _assert_logmel_close(got, kernel)
    dense = mel.log_mel_spectrogram_plain(torch.from_numpy(x), n_mels=n_mels).numpy()
    _assert_logmel_close(got, dense)


def test_kernel_bases_split_into_tf32_hi_and_lo():
    """The bases as the kernel reads them: interleaved (re_k, im_k) rows,
    zero-padded to whole passes and k-steps; split into TF32 hi and lo
    (low 13 bits zero) whose sum is the fp32 basis to 2^-22 relative."""
    w_re, w_im, _ = mel._dft_constants(400, 80, 16000)
    bt = mel._interleaved_bases(400, 80, 16000, 208, 16)
    assert bt.shape == (416, 400)
    np.testing.assert_array_equal(bt[0:402:2], w_re.T)
    np.testing.assert_array_equal(bt[1:402:2], w_im.T)
    assert not bt[402:].any()
    assert mel._interleaved_bases(100, 80, 16000, 208, 16).shape == (208, 112)
    hi, lo = mel._split_tf32(bt)
    assert hi.dtype == lo.dtype == np.float32
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    err = np.abs(hi.astype(np.float64) + lo.astype(np.float64) - bt.astype(np.float64))
    assert np.all(err <= 2.0 ** -22 * np.abs(bt.astype(np.float64)))
    assert np.abs(lo).max() > 0 and np.all(np.abs(lo) <= 2.0 ** -11 * np.abs(bt) + 1e-45)


def test_log_mel_wrapper_is_plain_on_cpu_and_unbatched():
    x = torch.from_numpy(_waves(62, 1, 8000)[0])
    got = mel.log_mel_spectrogram(x)
    assert got.shape == (80, 51)
    np.testing.assert_array_equal(got.numpy(), mel.log_mel_spectrogram_plain(x).numpy())
    np.testing.assert_array_equal(got.numpy(), mel.log_mel_spectrogram(x[None])[0].numpy())


@pytest.mark.parametrize("variant,fused", [("tiny", False), ("tiny", True), ("large-v3", True)])
def test_preprocessor_matches_jax(variant, fused):
    x = _waves(63, 2, 32000)
    expected = np.asarray(JaxWhisperPreprocessor(variant, fused=False)(x))
    got = WhisperPreprocessor(variant, fused=fused, device="cpu")(x).numpy()
    assert got.shape == expected.shape == (2, 128 if variant == "large-v3" else 80, 200)
    np.testing.assert_allclose(got, expected, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("flag", [None, True, False])
def test_preprocessor_dispatch_flag(flag, monkeypatch):
    """``fused=None`` follows ``USE_MEL_KERNEL`` (auto: plain rFFT route on a
    CPU tensor); every route gives the same answer within the tolerance."""
    monkeypatch.setattr(mel, "USE_MEL_KERNEL", flag)
    x = torch.from_numpy(_waves(64, 1, 16000)[0])
    assert mel.use_mel_kernel(x) is bool(flag)
    got = WhisperPreprocessor()(x)
    np.testing.assert_allclose(got.numpy(), WhisperPreprocessor(fused=False)(x).numpy(), rtol=TOL, atol=TOL)
