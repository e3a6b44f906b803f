"""The Whisper transcription slice of the PyTorch port vs the JAX package, on the CPU.

A tiny Whisper (vocab 100, 2 layers, d_model 64, 80 mels) is loaded in the
JAX package from a synthetic OpenAI state dict made with
``numpy.random.default_rng``; its parameters pass through
``from_jax_params`` into the port. The weights are larger than a real
checkpoint's (0.3, position embeddings 3.0): with small ones the tied greedy
head just repeats its input token, and token identity would prove nothing.
On the CPU the JAX side runs its per-op XLA paths (its fused decode step and
kernels are TPU-only), so this holds the port's plain path — and, with the
dispatch flags forced on, the kernels' plain versions behind their
wrappers — against the reference.
"""

import jax
import numpy as np
import pytest
import torch

import pytorch_models_tpu.models.audio2text as jax_a2t
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.audio2text import Whisper, WhisperGenerator, WhisperPreprocessor
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.ops import gather, mel
from pytorch_models_tpu_torch.utils import from_jax_params

torch.set_num_threads(1)

TINY = dict(vocab_size=100, n_layers=2, d_model=64, n_mels=80)
INIT = [1, 2]
SOT_PREV = 3
MAX_TOKENS = 20
SR = 16000
# fp32 on both sides: the two frameworks sum in different orders.
# Encoder outputs are of order 3 (reading: 1.2e-5 apart). Logits reach ~33,
# ten times GPT-2's, and their noise scales with the largest of them
# (reading: 1.5e-4 apart, ~5e-6 of the largest), so they get 5e-4.
ENC_TOL = 1e-4
LOGIT_TOL = 5e-4


def _openai_state_dict(seed=101, s=0.3):
    r = np.random.default_rng(seed)
    d, nm, v = TINY["d_model"], TINY["n_mels"], TINY["vocab_size"]

    def rn(*shape, scale=s):
        return (r.standard_normal(shape) * scale).astype(np.float32)

    sd = {
        "encoder.conv1.weight": rn(d, nm, 3), "encoder.conv1.bias": rn(d),
        "encoder.conv2.weight": rn(d, d, 3), "encoder.conv2.bias": rn(d),
        "encoder.positional_embedding": rn(1500, d),
        "decoder.token_embedding.weight": rn(v, d, scale=1.0),
        "decoder.positional_embedding": rn(448, d, scale=3.0),
        "encoder.ln_post.weight": 1 + rn(d, scale=0.02), "encoder.ln_post.bias": rn(d, scale=0.02),
        "decoder.ln.weight": 1 + rn(d, scale=0.02), "decoder.ln.bias": rn(d, scale=0.02),
    }

    def attn_block(pfx):  # OpenAI's key projection has no bias
        sd.update({f"{pfx}.query.weight": rn(d, d), f"{pfx}.query.bias": rn(d), f"{pfx}.key.weight": rn(d, d),
                   f"{pfx}.value.weight": rn(d, d), f"{pfx}.value.bias": rn(d),
                   f"{pfx}.out.weight": rn(d, d), f"{pfx}.out.bias": rn(d)})

    def ln(pfx):
        sd.update({f"{pfx}.weight": 1 + rn(d, scale=0.02), f"{pfx}.bias": rn(d, scale=0.02)})

    for side in ("encoder", "decoder"):
        for i in range(TINY["n_layers"]):
            pfx = f"{side}.blocks.{i}"
            attn_block(f"{pfx}.attn")
            ln(f"{pfx}.attn_ln")
            if side == "decoder":
                attn_block(f"{pfx}.cross_attn")
                ln(f"{pfx}.cross_attn_ln")
            sd.update({f"{pfx}.mlp.0.weight": rn(4 * d, d), f"{pfx}.mlp.0.bias": rn(4 * d),
                       f"{pfx}.mlp.2.weight": rn(d, 4 * d), f"{pfx}.mlp.2.bias": rn(d)})
            ln(f"{pfx}.mlp_ln")
    return sd


def _audios():
    """A 3 s tone in noise and 7 s of pulsed noise: rows that decode apart."""
    r = np.random.default_rng(7)
    t = np.arange(7 * SR) / SR
    a = 0.5 * np.sin(2 * np.pi * 440 * t[:3 * SR]) + 0.05 * r.standard_normal(3 * SR)
    b = 0.3 * r.standard_normal(7 * SR) * np.sin(2 * np.pi * 3 * t)
    return [a.astype(np.float32), b.astype(np.float32)]


def _pick_eot(rows):
    """A token row 0 generates after >= 3 other tokens, first seen at another
    step (or never) in row 1, so the rows stop at different steps."""
    g0, g1 = (r[len(INIT):] for r in rows)
    for i, t in enumerate(g0[3:], start=3):
        if t not in g0[:i] and (t not in g1 or g1.index(t) != i):
            return t
    raise AssertionError(f"no usable EOT in {rows}")


@pytest.fixture(scope="module")
def models():
    sd = _openai_state_dict()
    ref = jax_a2t.Whisper(**TINY)
    ref.load_openai_state_dict(sd)
    ours = Whisper(**TINY, device="cpu")
    ours.params = from_jax_params(jax.tree.map(to_np, ref.params))
    return ref, ours, sd


@pytest.fixture(scope="module")
def jax_outputs(models):
    ref, _, _ = models
    audios = _audios()
    gen = jax_a2t.WhisperGenerator(ref)
    padded = np.stack([np.pad(a, (0, gen.N_SAMPLES - len(a))) for a in audios])
    mel_in = np.array(jax_a2t.WhisperPreprocessor(fused=False)(padded))  # writable, for torch.from_numpy
    targets = np.random.default_rng(3).integers(0, TINY["vocab_size"], (2, 17))
    no_eot = gen.transcribe_tokens_batch(audios, INIT, eot_id=-1, max_tokens=MAX_TOKENS)
    eot = _pick_eot(no_eot)
    long_audio = np.concatenate([padded[0], audios[1][: 5 * SR]])  # 35 s: two windows
    return {
        "audios": audios, "mel": mel_in, "targets": targets, "eot": eot, "no_eot": no_eot,
        "memory": np.asarray(ref.encode(mel_in)), "logits": np.asarray(ref(mel_in, targets)),
        "batch": gen.transcribe_tokens_batch(audios, INIT, eot_id=eot, max_tokens=MAX_TOKENS),
        "single": [gen.transcribe_tokens(a, INIT, eot_id=eot, max_tokens=MAX_TOKENS) for a in audios],
        "long_audio": long_audio,
        "long": gen.transcribe_long_tokens(long_audio, INIT, eot, max_tokens=MAX_TOKENS),
        "long_prev": gen.transcribe_long_tokens(long_audio, INIT, eot, sot_prev_id=SOT_PREV, ctx_tokens=3,
                                                max_tokens=MAX_TOKENS),
    }


@pytest.fixture(params=["plain", "kernel_wrappers"])
def flags(request, monkeypatch):
    """"plain": every dispatch flag False (the JAX package's XLA route).
    "kernel_wrappers": every flag True — on CPU tensors the wrappers run
    their kernels' plain versions, so this covers the kernel dispatch."""
    on = request.param == "kernel_wrappers"
    for mod, name in ((attn, "USE_DECODE_KERNEL"), (attn, "USE_ENCODER_KERNEL"), (attn, "USE_GREEDY_HEAD"),
                      (gather, "USE_GATHER_KERNEL"), (mel, "USE_MEL_KERNEL")):
        monkeypatch.setattr(mod, name, on)
    return request.param


def test_greedy_streams_are_not_trivial(jax_outputs):
    rows = jax_outputs["no_eot"]
    assert all(len(set(r[len(INIT):])) >= 3 for r in rows)
    assert rows[0] != rows[1]
    batch = jax_outputs["batch"]
    assert len(batch[0]) != len(batch[1]) and batch[0][-1] == jax_outputs["eot"]


def test_load_openai_state_dict_matches_jax(models):
    ref, _, sd = models
    ours = Whisper(**TINY, device="cpu")
    ours.load_openai_state_dict(sd)
    expected = from_jax_params(jax.tree.map(to_np, ref.params))
    flat_got = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), ours.params))
    flat_exp = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), expected)))
    assert len(flat_got) == len(flat_exp)
    for path, leaf in flat_got:
        np.testing.assert_array_equal(leaf, flat_exp[path])


def test_encode_and_logits_match_jax(models, jax_outputs, flags):
    _, ours, _ = models
    mel_in = torch.from_numpy(jax_outputs["mel"])
    memory = ours.encode(mel_in)
    assert memory.shape == (2, 1500, TINY["d_model"])
    np.testing.assert_allclose(memory.numpy(), jax_outputs["memory"], atol=ENC_TOL, rtol=0)
    logits = ours(mel_in, jax_outputs["targets"])
    assert logits.shape == (2, 17, TINY["vocab_size"])
    np.testing.assert_allclose(logits.numpy(), jax_outputs["logits"], atol=LOGIT_TOL, rtol=0)


def test_preprocessor_batch_matches_jax(jax_outputs, flags):
    audios = jax_outputs["audios"]
    padded = np.stack([np.pad(a, (0, WhisperGenerator.N_SAMPLES - len(a))) for a in audios])
    got = WhisperPreprocessor(device="cpu")(padded).numpy()
    np.testing.assert_allclose(got, jax_outputs["mel"], atol=1e-4, rtol=1e-4)


def test_transcribe_tokens_match_jax(models, jax_outputs, flags):
    _, ours, _ = models
    gen = WhisperGenerator(ours)
    eot, audios = jax_outputs["eot"], jax_outputs["audios"]
    assert gen.transcribe_tokens_batch(audios, INIT, eot, MAX_TOKENS) == jax_outputs["batch"]
    assert [gen.transcribe_tokens(a, INIT, eot, MAX_TOKENS) for a in audios] == jax_outputs["single"]
    assert gen.transcribe_tokens_batch(audios, INIT, -1, MAX_TOKENS) == jax_outputs["no_eot"]


def test_transcribe_long_tokens_match_jax(models, jax_outputs, flags):
    _, ours, _ = models
    gen = WhisperGenerator(ours)
    eot, audio = jax_outputs["eot"], jax_outputs["long_audio"]
    assert gen.transcribe_long_tokens(audio, INIT, eot, max_tokens=MAX_TOKENS) == jax_outputs["long"]
    got = gen.transcribe_long_tokens(audio, INIT, eot, sot_prev_id=SOT_PREV, ctx_tokens=3, max_tokens=MAX_TOKENS)
    assert got == jax_outputs["long_prev"]
    assert len(got) == 2 and len(got[0]) >= 3  # the second window ran with a context prompt


def test_bf16_logits_match_jax(models, jax_outputs):
    ref, ours, _ = models
    ref_bf16 = jax_a2t.Whisper(**TINY)
    ref_bf16.params = ref.params
    ref_bf16.to_bf16()
    ours_bf16 = Whisper(**TINY, device="cpu")
    ours_bf16.params = ours.params
    ours_bf16.to_bf16()
    mel_in, targets = jax_outputs["mel"], jax_outputs["targets"]
    expected = np.asarray(ref_bf16(mel_in, targets).astype(np.float32))
    got = ours_bf16(torch.from_numpy(mel_in), targets).float().numpy()
    # bf16 keeps 8 significant bits; both sides round params, matmul
    # outputs and scores to bf16 at the same points but sum in fp32 in
    # different orders, so hidden values land a bf16 step or two apart and
    # that grows through 4 layers. With this model's large weights the bf16
    # logits themselves depart from the fp32 ones by up to ~3 (reading), so
    # two bf16 runs can differ by as much: readings 1.6 at most, 0.06 at the
    # median. Held: at most 2.0, median 0.15, argmax agreeing on 90%.
    diff = np.abs(got - expected)
    assert diff.max() <= 2.0 and np.median(diff) <= 0.15
    assert (got.argmax(-1) == expected.argmax(-1)).mean() >= 0.9


def test_from_openai_and_text_entry_points(models, jax_outputs, monkeypatch, tmp_path):
    import requests

    from tests.torch_pretrained_cache import offline

    m = Whisper.from_openai("tiny.en", device="cpu")
    assert (m.cfg.n_layers, m.cfg.d_model, m.cfg.vocab_size, m.cfg.n_mels) == (4, 384, 51864, 80)
    with monkeypatch.context() as mp:  # an empty cache and no network: the download fails
        offline(mp, tmp_path)
        with pytest.raises(requests.ConnectionError):
            Whisper.from_openai("tiny", pretrained=True, device="cpu")
    _, ours, _ = models
    gen = WhisperGenerator(ours)
    audio = jax_outputs["audios"][0]
    with pytest.raises(ValueError):
        gen.transcribe(audio)
    with pytest.raises(ValueError):
        gen.transcribe_long(audio)
    with pytest.raises(ValueError):
        gen.transcribe_tokens(audio, INIT, 0, max_tokens=449)

    class Tok:
        eot = jax_outputs["eot"]
        special_tokens = {"<|startofprev|>": SOT_PREV}

        def sot_sequence(self, language, task):
            return INIT

        def decode(self, ids):
            return " ".join(map(str, ids))

    gen.tokenizer = Tok()
    assert gen.transcribe(audio, max_tokens=MAX_TOKENS) == Tok().decode(jax_outputs["single"][0])
