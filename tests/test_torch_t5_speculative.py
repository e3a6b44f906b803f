"""Speculative T5 generation in the PyTorch port vs the JAX package, on the
CPU.

Greedy seq2seq speculative decoding is exact: for any draft the port's
``SpeculativeT5Generator`` must give the tokens of its own plain
``T5Generator`` and of the JAX package's ``SpeculativeT5Generator`` on the
same weights: a random draft (k = 1, 3, 4), the identical draft, a draft of
another width, depth and head count, a truncated draft (the first layer of
both stacks), an EOS stop and the budget cap; batched rows (differing
encoder lengths) against JAX's batched output and the one-row path; the
draft steps through the fused step's plain twin (``USE_FUSED_STEP = True``,
K7-T5 at B = 1, where the JAX package's drafts run per-op) with one verify
chunk per iteration; per-row positions with the per-row rel-pos bias
through the decode attention's plain version (its wrapper forced on).

Models: the JAX tests' shapes (vocab 100, d 64, 2 heads of 64, 2 + 2
layers, mlp 128; the smaller draft d 32, one head, one layer, mlp 64) from
the JAX init, with both stacks' rel-pos tables seeded at N(0, 1) x 2 (the
init's are zeros, which would leave every bias path unexercised), bridged
into the port by ``from_jax_params``. fp32 throughout; tokens exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_models_tpu.text import SpeculativeT5Generator as JaxSpec
from pytorch_models_tpu.text import T5Model as JaxT5
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.models.text import t5 as t5_mod
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.ops import decode_step
from pytorch_models_tpu_torch.text import SpeculativeT5Generator, T5Generator, T5Model
from pytorch_models_tpu_torch.utils import from_jax_params

torch.set_num_threads(1)

TINY = dict(vocab_size=100, dim=64, n_heads=2, n_layers=2, mlp_dim=128)
SMALLER = dict(vocab_size=100, dim=32, n_heads=1, n_layers=1, mlp_dim=64)
PAD, EOS, NO_EOS = 0, 1, 999
PROMPT = [(i % 97) + 2 for i in range(20)]
ROWS = [PROMPT, [(i % 89) + 3 for i in range(9)], [(i % 50) + 2 for i in range(33)]]


def _pair(dims: dict, rng: int):
    """(JAX model, port model) on one set of weights: the JAX init with
    seeded rel-pos tables."""
    ref = JaxT5(**dims, rng=rng)
    p = jax.tree.map(to_np, ref.params)
    r = np.random.default_rng(rng + 50)
    for side in ("encoder", "decoder"):
        p[side]["attn_bias"] = (2.0 * r.standard_normal(p[side]["attn_bias"].shape)).astype(np.float32)
    ref.params = jax.tree.map(jnp.asarray, p)
    ours = T5Model(**dims, device="cpu")
    ours.params = from_jax_params(p)
    return ref, ours


@pytest.fixture(scope="module")
def models():
    return {"target": _pair(TINY, 0), "random": _pair(TINY, 7), "smaller": _pair(SMALLER, 3)}


def _plain(model, prompt, max_tokens, eos):
    return T5Generator(model=model).generate_tokens(prompt, max_tokens, PAD, eos)


# (draft ("same": the target; "truncated": its first layer of both stacks), k, max_tokens, eos)
CASES = {
    "random_k1": ("random", 1, 24, EOS), "random_k3": ("random", 3, 24, EOS), "random_k4": ("random", 4, 24, EOS),
    "identical_k4": ("same", 4, 24, EOS), "smaller_k3": ("smaller", 3, 24, EOS),
    "truncated_k3": ("truncated", 3, 24, EOS), "eos_k3": ("random", 3, 24, "fifth"),
    "budget_k4": ("random", 4, 24, NO_EOS),
}


def _gens(models, case: str):
    draft, k, max_tokens, eos = CASES[case]
    jt, ot = models["target"]
    if eos == "fifth":  # the plain run's 5th generated token (index 0 is the pad start)
        eos = _plain(ot, PROMPT, max_tokens, NO_EOS)[5]
    if draft == "truncated":
        return (JaxSpec.with_truncated_draft(jt, object(), 1, k=k),
                SpeculativeT5Generator.with_truncated_draft(ot, None, 1, k=k), max_tokens, eos)
    jd, od = (jt, ot) if draft == "same" else models[draft]
    return JaxSpec(jt, jd, object(), k=k), SpeculativeT5Generator(ot, od, k=k), max_tokens, eos


@pytest.fixture(scope="module")
def jax_tokens(models):
    out = {}
    for case in CASES:
        jgen, _, max_tokens, eos = _gens(models, case)
        out[case] = jgen.generate_tokens(PROMPT, max_tokens, PAD, eos)
    return out


def _count_chunks(monkeypatch, k: int) -> list:
    """Spies on the per-op chunk forward: the (k+1)-token calls are verify chunks."""
    calls = []
    real = t5_mod._t5_spec_chunk_forward

    def spy(params, cfg, st, chunk, pos):
        calls.append(chunk.shape[1] == k + 1)
        return real(params, cfg, st, chunk, pos)

    monkeypatch.setattr(t5_mod, "_t5_spec_chunk_forward", spy)
    return calls


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_and_plain(models, jax_tokens, monkeypatch, case):
    _, gen, max_tokens, eos = _gens(models, case)
    assert gen.last_iters is None and gen.last_accept_rate is None
    chunks = _count_chunks(monkeypatch, gen.k)
    got = gen.generate_tokens(PROMPT, max_tokens, PAD, eos)
    assert got == jax_tokens[case]
    assert got == _plain(gen.model, PROMPT, max_tokens, eos)
    assert sum(chunks) == gen.last_iters >= 1 and -1e-9 <= gen.last_accept_rate <= 1 + 1e-9
    if eos == NO_EOS:
        assert len(got) == max_tokens
    elif case == "eos_k3":
        assert got[-1] == eos and eos not in got[1:-1]


def test_streams_move(jax_tokens):
    assert len(set(jax_tokens["random_k3"][1:])) >= 8


def test_truncated_draft_cuts_both_stacks(models):
    _, target = models["target"]
    gen = SpeculativeT5Generator.with_truncated_draft(target, None, 1)
    dp = gen.draft_model.params
    assert gen.draft_model.cfg.n_layers == 1
    for stack in ("encoder", "decoder"):
        assert len(dp[stack]["layers"]) == 1 and dp[stack]["layers"][0] is target.params[stack]["layers"][0]
        assert dp[stack]["attn_bias"] is target.params[stack]["attn_bias"]
        assert len(target.params[stack]["layers"]) == 2


@pytest.mark.parametrize("case", ["random_k3", "identical_k4"])
def test_fused_draft_matches_jax(models, jax_tokens, monkeypatch, case):
    """USE_FUSED_STEP = True: the draft's steps (the pad token's included)
    go through K7-T5's plain twin at B = 1 with its untied head, and the
    tokens stay JAX's per-op draft's."""
    calls = []
    real = decode_step.fused_cross_decode_step

    def spy(x, packed, kc, *a, **kw):
        calls.append((kc.shape[1], kw.get("head") is not None, kw.get("norm")))
        return real(x, packed, kc, *a, **kw)

    monkeypatch.setattr(attn, "USE_FUSED_STEP", True)
    monkeypatch.setattr(decode_step, "fused_cross_decode_step", spy)
    _, gen, max_tokens, eos = _gens(models, case)
    chunks = _count_chunks(monkeypatch, gen.k)
    assert gen.generate_tokens(PROMPT, max_tokens, PAD, eos) == jax_tokens[case]
    assert calls == [(1, True, "rms")] * (gen.k * gen.last_iters + 1)
    assert sum(chunks) == gen.last_iters and len(chunks) == gen.last_iters + 1  # + the target's pad-token step


BATCHED = {"random_k2": ("random", 2), "random_k4": ("random", 4), "identical_k4": ("same", 4)}


@pytest.fixture(scope="module")
def jax_batched(models):
    out = {}
    jt, _ = models["target"]
    for case, (draft, k) in BATCHED.items():
        jd = jt if draft == "same" else models[draft][0]
        out[case] = JaxSpec(jt, jd, object(), k=k).generate_tokens_batch(ROWS, 20, PAD, EOS)
    return out


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "decode_kernel_wrapper"])
@pytest.mark.parametrize("case", list(BATCHED))
def test_batch_matches_jax_and_one_row(models, jax_batched, monkeypatch, case, kernel):
    """Rows with differing encoder lengths, per-row acceptance, positions
    and rel-pos bias rows; with the decode attention's wrapper forced, the
    per-row drafts take its plain version with per-row ends and the
    per-row key-major bias."""
    monkeypatch.setattr(attn, "USE_DECODE_KERNEL", kernel)
    draft, k = BATCHED[case]
    _, ot = models["target"]
    od = ot if draft == "same" else models[draft][1]
    gen = SpeculativeT5Generator(ot, od, k=k)
    got = gen.generate_tokens_batch(ROWS, 20, PAD, EOS)
    assert got == jax_batched[case]
    assert got == [gen.generate_tokens(r, 20, PAD, EOS) for r in ROWS]
    assert got == [_plain(ot, r, 20, EOS) for r in ROWS]


def test_entry_points(models):
    _, target = models["target"]

    class Tok:
        def Encode(self, text, add_eos=False):
            return PROMPT

        def Decode(self, ids):
            return " ".join(map(str, ids))

        def pad_id(self):
            return PAD

        def eos_id(self):
            return EOS

    gen = SpeculativeT5Generator(target, models["random"][1], Tok(), k=3)
    text = gen.generate("x", max_tokens=12)
    assert text == " ".join(map(str, _plain(target, PROMPT, 12, EOS)))
    assert gen.generate_batch(["x", "y"], max_tokens=12) == [text, text]
    with pytest.raises(ValueError):
        SpeculativeT5Generator(target, models["random"][1]).generate("x")
    with pytest.raises(ValueError):
        SpeculativeT5Generator(target, T5Model(**dict(TINY, vocab_size=101), device="cpu"))
