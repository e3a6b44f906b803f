"""Speculative Whisper transcription in the PyTorch port vs the JAX
package, on the CPU.

Greedy speculative transcription is exact: for any draft the port's
``SpeculativeWhisperGenerator`` must give the tokens of its own plain
``WhisperGenerator`` and of the JAX package's
``SpeculativeWhisperGenerator`` on the same weights: a random draft (k = 1,
3), the identical draft, a draft of another depth, a truncated draft (the
first layer of both stacks), an EOT stop, the budget cap and the position
table's edge (448 tokens: the loop stops up to k tokens early); batched
segments against JAX's batched output and the one-segment path; the draft
steps through the fused step's plain twin (``USE_FUSED_STEP = True``, the
cross variant at B = 1 with its head), one verify chunk per iteration.

Models: the JAX tests' shapes (vocab 100, d 64, one head of 64, 2 + 2
layers, 80 mels; the smaller draft one layer) from the JAX init, then made
to move (decoder token embeddings x 0.3, decoder position embeddings N(0,
1) x 2, every layer matrix x 3: at the init's scale the stream repeats the
last initial token), bridged into the port by ``from_jax_params``. fp32
throughout; tokens exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_models_tpu.audio2text import SpeculativeWhisperGenerator as JaxSpec
from pytorch_models_tpu.audio2text import Whisper as JaxWhisper
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.audio2text import SpeculativeWhisperGenerator, Whisper, WhisperGenerator
from pytorch_models_tpu_torch.models.audio2text import whisper as whisper_mod
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.ops import decode_step
from pytorch_models_tpu_torch.utils import from_jax_params

torch.set_num_threads(1)

TINY = dict(vocab_size=100, n_layers=2, d_model=64, n_mels=80)
SMALLER = dict(vocab_size=100, n_layers=1, d_model=64, n_mels=80)
INIT = [50, 51, 52]
EOT = 99  # never generated by these models: the budget caps the runs


def _pair(dims: dict, rng: int):
    """(JAX model, port model) on one set of weights: the JAX init, moved."""
    ref = JaxWhisper(**dims, rng=rng)
    p = jax.tree.map(to_np, ref.params)
    r = np.random.default_rng(rng + 50)
    dec = p["decoder"]
    dec["token_embs"] = dec["token_embs"] * np.float32(0.3)
    dec["pos_embs"] = (2.0 * r.standard_normal(dec["pos_embs"].shape)).astype(np.float32)
    for side in ("encoder", "decoder"):
        for block in p[side]["layers"].values():
            for lin in block.values():
                if isinstance(lin, dict) and "w" in lin:
                    lin["w"] = lin["w"] * np.float32(3.0)
    ref.params = jax.tree.map(jnp.asarray, p)
    ours = Whisper(**dims, device="cpu")
    ours.params = from_jax_params(p)
    return ref, ours


@pytest.fixture(scope="module")
def models():
    return {"target": _pair(TINY, 0), "random": _pair(TINY, 9), "smaller": _pair(SMALLER, 3)}


@pytest.fixture(scope="module")
def audios():
    r = np.random.default_rng(11)
    return [(np.random.default_rng(7).standard_normal(16000) * 0.1).astype(np.float32),
            (r.standard_normal(16000) * 0.1).astype(np.float32), (r.standard_normal(8000) * 0.2).astype(np.float32)]


def _plain(model, audio, eot, max_tokens):
    return WhisperGenerator(model).transcribe_tokens(audio, INIT, eot, max_tokens)


# (draft ("same": the target; "truncated": its first layer of both stacks), k, max_tokens, eot)
CASES = {
    "random_k1": ("random", 1, 32, EOT), "random_k3": ("random", 3, 32, EOT), "identical_k4": ("same", 4, 32, EOT),
    "smaller_k3": ("smaller", 3, 32, EOT), "truncated_k3": ("truncated", 3, 32, EOT),
    "eot_k3": ("random", 3, 32, "fifth"), "edge_k4": ("same", 4, 448, EOT),
}


def _gens(models, audio, case: str):
    draft, k, max_tokens, eot = CASES[case]
    jt, ot = models["target"]
    if eot == "fifth":  # the first token new to the plain run from its 5th generated on
        gen = _plain(ot, audio, EOT, max_tokens)[len(INIT):]
        eot = next(t for i, t in enumerate(gen) if i >= 4 and t not in gen[:i])
    if draft == "truncated":
        return (JaxSpec.with_truncated_draft(jt, n_layers=1, k=k),
                SpeculativeWhisperGenerator.with_truncated_draft(ot, n_layers=1, k=k), max_tokens, eot)
    jd, od = (jt, ot) if draft == "same" else models[draft]
    return JaxSpec(jt, jd, k=k), SpeculativeWhisperGenerator(ot, od, k=k), max_tokens, eot


@pytest.fixture(scope="module")
def jax_tokens(models, audios):
    out = {}
    for case in CASES:
        jgen, _, max_tokens, eot = _gens(models, audios[0], case)
        out[case] = jgen.transcribe_tokens(audios[0], INIT, eot, max_tokens)
    return out


def _count_chunks(monkeypatch, k: int) -> list:
    """Spies on the decoder's logits chunk: the (k+1)-token calls are verify chunks."""
    calls = []
    real = whisper_mod._decoder_logits_chunk

    def spy(p, lc, cross, tokens, caches, pos):
        calls.append(tokens.shape[1] == k + 1)
        return real(p, lc, cross, tokens, caches, pos)

    monkeypatch.setattr(whisper_mod, "_decoder_logits_chunk", spy)
    return calls


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_and_plain(models, audios, jax_tokens, monkeypatch, case):
    _, gen, max_tokens, eot = _gens(models, audios[0], case)
    assert gen.last_iters is None and gen.last_accept_rate is None
    chunks = _count_chunks(monkeypatch, gen.k)
    got = gen.transcribe_tokens(audios[0], INIT, eot, max_tokens)
    assert got == jax_tokens[case]
    assert sum(chunks) == gen.last_iters >= 1 and -1e-9 <= gen.last_accept_rate <= 1 + 1e-9
    base = _plain(gen.model, audios[0], eot, max_tokens)
    if case == "edge_k4":  # at the 448-slot table's edge the loop stops up to k tokens early
        assert len(base) - gen.k <= len(got) <= len(base) == 448 and got == base[:len(got)]
    else:
        assert got == base
    if eot == EOT and case != "edge_k4":
        assert len(got) == max_tokens
    elif case == "eot_k3":
        assert got[-1] == eot and eot not in got[len(INIT):-1]


def test_streams_move(jax_tokens):
    assert len(set(jax_tokens["random_k3"][len(INIT):])) >= 5


@pytest.mark.parametrize("case", ["random_k3", "identical_k4"])
def test_fused_draft_matches_jax(models, audios, jax_tokens, monkeypatch, case):
    """USE_FUSED_STEP = True: each draft step is one call of the fused
    cross step's plain twin at B = 1 with its greedy head."""
    calls = []
    real = decode_step.fused_cross_decode_step

    def spy(x, packed, kc, *a, **kw):
        calls.append((kc.shape[1], kw.get("head") is not None))
        return real(x, packed, kc, *a, **kw)

    monkeypatch.setattr(attn, "USE_FUSED_STEP", True)
    monkeypatch.setattr(decode_step, "fused_cross_decode_step", spy)
    _, gen, max_tokens, eot = _gens(models, audios[0], case)
    chunks = _count_chunks(monkeypatch, gen.k)
    assert gen.transcribe_tokens(audios[0], INIT, eot, max_tokens) == jax_tokens[case]
    assert calls == [(1, True)] * (gen.k * gen.last_iters)
    assert sum(chunks) == len(chunks) == gen.last_iters


def test_batch_matches_jax_and_one_segment(models, audios):
    """Per-segment acceptance and positions (the smaller draft): each row
    equals JAX's batched row, the port's one-segment path and its plain
    transcription; a row stopped by its EOT parks."""
    jt, ot = models["target"]
    jd, od = models["smaller"]
    eot = _plain(ot, audios[1], EOT, 24)[len(INIT) + 3]
    want = JaxSpec(jt, jd, k=3).transcribe_tokens_batch(audios, INIT, eot, max_tokens=24)
    gen = SpeculativeWhisperGenerator(ot, od, k=3)
    got = gen.transcribe_tokens_batch(audios, INIT, eot, max_tokens=24)
    assert got == want
    assert got == [gen.transcribe_tokens(a, INIT, eot, 24) for a in audios]
    assert got == [_plain(ot, a, eot, 24) for a in audios]
    assert got[1][-1] == eot and len(got[1]) < 24


def test_truncated_draft_and_entry_points(models, audios):
    _, target = models["target"]
    gen = SpeculativeWhisperGenerator.with_truncated_draft(target, n_layers=1, k=2)
    for stack in ("encoder", "decoder"):
        layers = gen.draft_model.params[stack]["layers"]
        assert len(layers) == 1 and layers[0] is target.params[stack]["layers"][0]
    assert gen.draft_model.cfg.n_layers == 1 and len(target.params["decoder"]["layers"]) == 2
    with pytest.raises(ValueError):
        gen.transcribe(audios[0])  # no tokenizer

    class Tok:
        eot = EOT

        def sot_sequence(self, language, task):
            return INIT

        def decode(self, ids):
            return " ".join(map(str, ids))

    gen.tokenizer = Tok()
    assert gen.transcribe(audios[0], max_tokens=16) == " ".join(map(str, _plain(target, audios[0], EOT, 16)))
    with pytest.raises(ValueError):
        gen.transcribe_tokens(audios[0], INIT, EOT, max_tokens=449)
