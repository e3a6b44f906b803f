"""Beam search in the PyTorch port vs the JAX package, on the CPU.

GPT-2 (``DecoderGenerator.beam_search_tokens{,_batch}``), Whisper
(``WhisperGenerator.transcribe_beam_tokens``) and T5
(``T5Generator.generate_beam_tokens``) on the same fp32 parameters in both
packages: the beams must be token-identical to JAX's and their scores
within 1e-5 absolute + 1e-5 relative (fp32 log-probs summed over a few
steps, in other orders). Each case runs on three routes of the port: the
fused step forced on (its plain twin, headless: the layer stack only; the
final norm and the head in torch), the per-op kernel wrappers (their plain
versions) and plain; on both sides of one fused launch's 32 rows
(``ops.decode_step.MAX_LAUNCH_ROWS``: G*W = 8, 12 and 36 for GPT-2, W = 4, 12
and 36 for Whisper and T5; on the card 36 rows run as launches over row
slices, here the twin takes the whole batch). The JAX side runs its XLA
paths. W = 1
must equal the port's greedy tokens.

The models: tests/test_torch_sampling.py's GPT-2 (2 layers, d 64, vocab
300), tests/test_torch_whisper.py's Whisper (vocab 100, 2 layers, d 64)
and tests/test_torch_t5.py's T5 (vocab 100, d 128, 2 heads, 2 + 2 layers,
rel-pos tables at 2.0), each with weights large enough that the greedy
streams move.
"""

from functools import cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_models_tpu.models.audio2text as jax_a2t
import pytorch_models_tpu.models.text as jax_text
from pytorch_models_tpu.models.audio2text import whisper as jax_whisper
from pytorch_models_tpu.models.text import t5 as jax_t5
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.audio2text import Whisper, WhisperGenerator
from pytorch_models_tpu_torch.models.audio2text import whisper as whisper_mod
from pytorch_models_tpu_torch.models.text import beam
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.ops import decode_step, gather, mel
from pytorch_models_tpu_torch.text import DecoderGenerator, T5Generator, T5Model
from pytorch_models_tpu_torch.utils import from_jax_params
from tests.test_torch_sampling import Tok, small_gpt2_pair
from tests.test_torch_t5 import DIMS as T5_DIMS
from tests.test_torch_t5 import _t5x_flat
from tests.test_torch_whisper import LOGIT_TOL as W_LOGIT_TOL
from tests.test_torch_whisper import TINY as W_TINY
from tests.test_torch_whisper import _audios, _openai_state_dict

torch.set_num_threads(1)

ATOL = RTOL = 1e-5
# Whisper's beam scores: this model's logits reach ~33 (tests/test_torch_whisper.py sized its weights so the
# greedy streams move), where fp32 summation order moves a step's log-prob by up to ~5e-6; a score sums up to
# 14 of them. Between the port's own routes (the fused twin or the decode-attention twin against the plain
# matmuls) and JAX's: up to 6.8e-5 (a CPU reading). The sequences stay identical.
W_SCORE_TOL = 1e-4
PROMPTS = [[3, 1, 4], [2, 7, 1, 8, 2, 8], [5], list(range(20, 41))]
MAX_NEW = 10
W_INIT, W_MAX = [1, 2], 16
T5_PROMPT, T5_PAD, T5_MAX = [5, 9, 13, 2, 77, 31, 64], 0, 12


@cache
def gpt2():
    return small_gpt2_pair()


@cache
def whisper():
    sd = _openai_state_dict()
    ref = jax_a2t.Whisper(**W_TINY)
    ref.load_openai_state_dict(sd)
    ours = Whisper(**W_TINY, device="cpu")
    ours.params = from_jax_params(jax.tree.map(to_np, ref.params))
    return ref, ours, _audios()[1]


@cache
def t5():
    flat = _t5x_flat()
    ref = jax_t5.T5Model(**T5_DIMS)
    ref.load_t5x_state_dict(flat)
    ours = T5Model(**T5_DIMS, device="cpu")
    ours.load_t5x_state_dict(flat)
    return ref, ours


def _first_new(row, n_prompt):
    """An EOS that finishes some beams mid-way: the first token ``row``
    generates for the first time at step 3 or later, else the last new one."""
    g = row[n_prompt:]
    new = [(i, t) for i, t in enumerate(g) if i > 0 and t not in g[:i]]
    return next((t for i, t in new if i >= 3), new[-1][1])


@cache
def eos_ids():
    ref, _ = gpt2()
    row = jax_text.DecoderGenerator(ref, Tok()).generate_tokens(PROMPTS[0], max_tokens=MAX_NEW)
    w_ref, _, audio = whisper()
    w_row = jax_a2t.WhisperGenerator(w_ref).transcribe_tokens(audio, W_INIT, eot_id=-1, max_tokens=W_MAX)
    t5_ref, _ = t5()
    t5_row = jax_t5.T5Generator(model=t5_ref, tokenizer=object()).generate_tokens(T5_PROMPT, T5_MAX, T5_PAD, -1)
    return {"gpt2": _first_new(row, len(PROMPTS[0])), "whisper": _first_new(w_row, len(W_INIT)),
            "t5": _first_new(t5_row, 1)}


@cache
def jax_gpt2_beams(w, eos, alpha, g):
    ref, _ = gpt2()
    return jax_text.DecoderGenerator(ref, Tok(eos)).beam_search_tokens_batch(
        (PROMPTS * 3)[:g], max_tokens=MAX_NEW, beam_width=w, length_penalty=alpha, return_all=True)


ROUTES = {"fused": (True, True), "per-op": (True, False), "plain": (False, False)}


@pytest.fixture(params=list(ROUTES))
def route(request, monkeypatch):
    """The dispatch flags of each route; counts the fused step's twin calls
    (``decode_step.fused_decode_step`` / ``fused_cross_decode_step``) with
    and without a head."""
    kernels, fused = ROUTES[request.param]
    for mod, name in ((attn, "USE_DECODE_KERNEL"), (attn, "USE_ENCODER_KERNEL"), (attn, "USE_GREEDY_HEAD"),
                      (gather, "USE_GATHER_KERNEL"), (mel, "USE_MEL_KERNEL")):
        monkeypatch.setattr(mod, name, kernels)
    monkeypatch.setattr(attn, "USE_FUSED_STEP", fused)
    calls = {"headless": 0, "head": 0}
    for name in ("fused_decode_step", "fused_cross_decode_step"):
        real = getattr(decode_step, name)

        def spy(*args, real=real, **kw):
            calls["headless" if kw.get("head") is None else "head"] += 1
            return real(*args, **kw)

        monkeypatch.setattr(decode_step, name, spy)
    return request.param, calls


def _assert_beams(got, ref, atol=ATOL, rtol=RTOL):
    (seqs, scores), (ref_seqs, ref_scores) = got, ref
    assert seqs == ref_seqs
    np.testing.assert_allclose(scores, ref_scores, rtol=rtol, atol=atol)


def _fused_steps(name, rows, calls, steps):
    """The fused route's twin ran headless once per beam step at any rows
    (the kernel over row slices on the card above MAX_LAUNCH_ROWS), never
    on the other routes, and never with a head."""
    want = steps if name == "fused" else 0
    assert calls == {"headless": want, "head": 0}


@pytest.mark.parametrize("w", [1, 2, 4])
@pytest.mark.parametrize("with_eos", [False, True])
@pytest.mark.parametrize("alpha", [0.0, 0.6])
def test_gpt2_beam_batch_matches_jax(route, w, with_eos, alpha):
    name, calls = route
    _, ours = gpt2()
    eos = eos_ids()["gpt2"] if with_eos else None
    got = DecoderGenerator(ours, Tok(eos)).beam_search_tokens_batch(PROMPTS[:3], max_tokens=MAX_NEW, beam_width=w,
                                                                     length_penalty=alpha, return_all=True)
    _assert_beams(got, jax_gpt2_beams(w, eos, alpha, 3))
    if with_eos:
        assert any(s[-1] == eos for group in got[0] for s in group)  # some beam finished at EOS
    assert calls["head"] == 0 and (calls["headless"] > 0) == (name == "fused")


@pytest.mark.parametrize("g", [2, 3, 9])
def test_gpt2_beam_on_both_sides_of_the_fused_rows(route, monkeypatch, g):
    """G*W = 8, 12 and 36 rows (the fused step's twin when forced; on the
    card 36 rows run over row slices of at most MAX_LAUNCH_ROWS), W = 4,
    with EOS: the JAX beams, and the twin once per step."""
    name, calls = route
    _, ours = gpt2()
    eos = eos_ids()["gpt2"]
    steps = []
    real_loop = beam.beam_decode_loop_batched

    def loop(forward, *args):
        def counted(*a):
            steps.append(1)
            return forward(*a)
        return real_loop(counted, *args)

    monkeypatch.setattr(beam, "beam_decode_loop_batched", loop)
    got = DecoderGenerator(ours, Tok(eos)).beam_search_tokens_batch((PROMPTS * 3)[:g], max_tokens=MAX_NEW,
                                                                     beam_width=4, return_all=True)
    _assert_beams(got, jax_gpt2_beams(4, eos, 0.0, g))
    _fused_steps(name, 4 * g, calls, len(steps))


def test_gpt2_beam_single_and_greedy_width(route):
    _, ours = gpt2()
    ref, _ = gpt2()
    eos = eos_ids()["gpt2"]
    gen, jgen = DecoderGenerator(ours, Tok(eos)), jax_text.DecoderGenerator(ref, Tok(eos))
    _assert_beams(gen.beam_search_tokens(PROMPTS[3], max_tokens=MAX_NEW, beam_width=3, length_penalty=0.6,
                                         return_all=True),
                  jgen.beam_search_tokens(PROMPTS[3], max_tokens=MAX_NEW, beam_width=3, length_penalty=0.6,
                                          return_all=True))
    # W = 1 is greedy: without an EOS, and with one the greedy stream emits (a second-best EOS candidate
    # enters the finished pool and may win, so there W = 1 is not greedy, in JAX's beam as in this one)
    plain = DecoderGenerator(ours, Tok())
    greedy = plain.generate_tokens_batch(PROMPTS, max_tokens=MAX_NEW)
    assert plain.beam_search_tokens_batch(PROMPTS, max_tokens=MAX_NEW, beam_width=1) == greedy
    for p, row in zip(PROMPTS, greedy):
        at_eos = DecoderGenerator(ours, Tok(_first_new(row, len(p))))
        assert at_eos.beam_search_tokens(p, max_tokens=MAX_NEW, beam_width=1) == at_eos.generate_tokens(p, MAX_NEW)


def test_beam_degenerate_inputs_and_bad_arguments():
    _, ours = gpt2()
    gen = DecoderGenerator(ours, Tok())
    assert gen.beam_search_tokens(PROMPTS[0], max_tokens=0) == PROMPTS[0]
    assert gen.beam_search_tokens(PROMPTS[0], max_tokens=0, return_all=True) == ([PROMPTS[0]], [0.0])
    for kw in (dict(beam_width=0), dict(length_penalty=-0.5)):
        with pytest.raises(ValueError):
            gen.beam_search_tokens(PROMPTS[0], max_tokens=4, **kw)
    with pytest.raises(ValueError):
        gen.beam_search_tokens_batch([[1], []], max_tokens=4)


@cache
def whisper_memory():
    """JAX's encoder memory of the test segment (1, 1500, d) as numpy: both
    beam loops take it, so the encoders' summation orders do not enter."""
    ref, _, audio = whisper()
    gen = jax_a2t.WhisperGenerator(ref)
    mel = gen.preprocessor._forward(gen._stage_segment(audio))
    return np.asarray(jax_whisper._whisper_encode_body(ref.params, ref.cfg, mel))


@cache
def jax_whisper_beams(w, with_eot, alpha):
    ref, _, _ = whisper()
    eot = eos_ids()["whisper"] if with_eot else -1
    body = jax.jit(jax_whisper._whisper_beam_body, static_argnums=(1, 4, 6))
    seqs, scores, lens = (np.asarray(t) for t in body(ref.params, ref.cfg, jnp.asarray(whisper_memory()[0]),
                                                        jnp.asarray(W_INIT), W_MAX, eot, w, alpha))
    return [seqs[i, : lens[i]].tolist() for i in range(w)], scores.tolist()


@pytest.mark.parametrize("w, with_eot, alpha", [(4, False, 0.0), (4, True, 0.6), (12, True, 0.0), (36, True, 0.0)])
def test_whisper_beam_matches_jax(route, w, with_eot, alpha):
    """The beam loop over one encoded segment (``whisper._beam``) against
    JAX's ``_whisper_beam_body`` on the same memory."""
    name, calls = route
    _, ours, _ = whisper()
    eot = eos_ids()["whisper"] if with_eot else -1
    seqs, scores, lens = (t.numpy() for t in whisper_mod._beam(
        ours.params, ours.cfg, torch.from_numpy(whisper_memory().copy()), torch.tensor(W_INIT), W_MAX, eot, w, alpha))
    _assert_beams(([seqs[i, : lens[i]].tolist() for i in range(w)], scores.tolist()),
                  jax_whisper_beams(w, with_eot, alpha), atol=W_SCORE_TOL, rtol=0)
    assert calls["head"] == 0 and (calls["headless"] > 0) == (name == "fused")


def test_whisper_transcribe_beam_tokens_matches_jax(route):
    """The entry point, waveform in: the same beams as JAX's; the scores
    within LOGIT_TOL, as the port's frontend and encoder are held to JAX's
    (tests/test_torch_whisper.py: they sum in other orders, and this model's
    logits reach ~33)."""
    ref, ours, audio = whisper()
    eot = eos_ids()["whisper"]
    got = WhisperGenerator(ours).transcribe_beam_tokens(audio, W_INIT, eot, W_MAX, beam_width=4, length_penalty=0.6,
                                                        return_all=True)
    want = jax_a2t.WhisperGenerator(ref).transcribe_beam_tokens(audio, W_INIT, eot, W_MAX, beam_width=4,
                                                                length_penalty=0.6, return_all=True)
    assert got[0] == want[0] and all(s[:len(W_INIT)] == W_INIT for s in got[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=W_LOGIT_TOL)
    assert any(s[-1] == eot for s in got[0])


@cache
def jax_t5_beams(w, with_eos, alpha):
    ref, _ = t5()
    eos = eos_ids()["t5"] if with_eos else -1
    return jax_t5.T5Generator(model=ref, tokenizer=object()).generate_beam_tokens(
        T5_PROMPT, T5_MAX, T5_PAD, eos, beam_width=w, length_penalty=alpha, return_all=True)


@pytest.mark.parametrize("w, with_eos, alpha", [(4, False, 0.0), (4, True, 0.6), (12, True, 0.0), (36, True, 0.0)])
def test_t5_beam_matches_jax(route, w, with_eos, alpha):
    name, calls = route
    _, ours = t5()
    eos = eos_ids()["t5"] if with_eos else -1
    got = T5Generator(model=ours).generate_beam_tokens(T5_PROMPT, T5_MAX, T5_PAD, eos, beam_width=w,
                                                       length_penalty=alpha, return_all=True)
    _assert_beams(got, jax_t5_beams(w, with_eos, alpha))
    assert all(s[0] == T5_PAD for s in got[0])
    assert calls["head"] == 0 and (calls["headless"] > 0) == (name == "fused")


def test_whisper_and_t5_width_one_is_greedy():
    _, w_ours, audio = whisper()
    eot = eos_ids()["whisper"]
    wg = WhisperGenerator(w_ours)
    assert wg.transcribe_beam_tokens(audio, W_INIT, eot, W_MAX, beam_width=1) == \
        wg.transcribe_tokens(audio, W_INIT, eot, W_MAX)
    _, t_ours = t5()
    eos = eos_ids()["t5"]
    tg = T5Generator(model=t_ours)
    assert tg.generate_beam_tokens(T5_PROMPT, T5_MAX, T5_PAD, eos, beam_width=1) == \
        tg.generate_tokens(T5_PROMPT, T5_MAX, T5_PAD, eos)


def test_reorder_caches_gathers_the_written_prefix():
    """Row r of the reordered caches is row idx[r]'s up to ``pos``; the
    buffers swap, so the old ones become the next spare."""
    g = torch.Generator().manual_seed(0)
    stacked = {k: torch.randn(3, 4, 16, 8, generator=g) for k in ("k", "v")}
    caches = beam.beam_caches({k: v.clone() for k, v in stacked.items()})
    idx = torch.tensor([2, 2, 0, 1])
    views, new, spare = beam.reorder_caches(caches, idx, 5)
    assert spare is caches[1] and new is caches[2]
    for k in ("k", "v"):
        torch.testing.assert_close(new[k][:, :, :5], stacked[k][:, idx, :5], rtol=0, atol=0)
        assert views[1][k].data_ptr() == new[k][1].data_ptr()
    fanned = beam.fan_out_caches(stacked, torch.tensor([1, 1, 1]), 7)
    torch.testing.assert_close(fanned[1]["k"][:, :, :7], stacked["k"][:, [1, 1, 1], :7], rtol=0, atol=0)
    assert not fanned[1]["k"][:, :, 7:].any()
