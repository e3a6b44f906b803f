"""Speculative decoding of the decoder LM in the PyTorch port vs the JAX
package, on the CPU.

Greedy is exact: for any draft the port's ``SpeculativeDecoderGenerator``
must give the tokens of its own plain ``DecoderGenerator`` and of the JAX
package's ``SpeculativeDecoderGenerator`` on the same weights, and run the
same number of iterations (``last_iters`` against JAX's
``_speculative_generate_stats`` count, which its generator records): a
random draft, the identical draft, a truncated draft, a draft of another
width and depth; k = 1, 3, 4; an EOS stop, the budget cap and the buffer
edge (a prompt of 8 with 120 new tokens in a context of 128); batched rows
against JAX's batched output and the one-row path; the draft steps through
the fused step's plain twin (``USE_FUSED_STEP = True``). Also
``transformer.mha_apply``'s per-row ``cache_pos`` against its int form, row
by row.

Sampling: JAX's PRNG stream cannot be matched, so it is held by its
properties: an identity draft equals a positional plain sampler (a full
re-forward a token, the same counters) over an iteration, every token lies in the target's
top-k, the rejection core over 40k counter draws gives a first token
within 1% total variation of p_0 (and the bonus of p_k when q == p), greedy
arguments route to exact greedy, and batched rows reproduce one-row runs.

Models: the JAX tests' shapes (vocab 512, d 128, 2 heads of 64, 2 or 4
layers, context 128) from the JAX init, then made to move (token
embeddings x 0.2, position embeddings N(0, 1), layer matrices x 3: at the
init's scale the greedy stream repeats the last prompt token and the
sampled distribution is one token), bridged into the port by
``from_jax_params``. fp32 throughout; tokens exactly.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_models_tpu.models.text import speculative as jax_spec
from pytorch_models_tpu.models.text._decoder_lm import DecoderLMConfig as JaxConfig
from pytorch_models_tpu.models.text._decoder_lm import decoder_lm_init as jax_init
from pytorch_models_tpu.text import SpeculativeDecoderGenerator as JaxSpec
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch import transformer as tfm
from pytorch_models_tpu_torch.models.text import speculative as spec
from pytorch_models_tpu_torch.models.text._decoder_lm import DecoderLMConfig, decoder_lm_apply
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.ops import decode_step
from pytorch_models_tpu_torch.text import GPT2, DecoderGenerator, SpeculativeDecoderGenerator
from pytorch_models_tpu_torch.utils import from_jax_params

torch.set_num_threads(1)

PROMPT = [3, 1, 4, 1, 5]
EDGE_PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]
BATCH = [[3, 1, 4], [3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8, 1, 8, 2]]
SAMPLINGS = [dict(topk=8, top_p=None, temperature=1.0), dict(topk=1, top_p=0.9, temperature=0.7),
             dict(topk=16, top_p=0.95, temperature=1.3)]


class Tok:
    def __init__(self, eos=None):
        self.eos_token_id = eos

    def encode(self, s):
        return list(PROMPT)

    def decode(self, ids):
        return " ".join(map(str, ids))


def _pair(seed: int, n_layers: int = 2, d_model: int = 128):
    """(JAX model, port model) on one set of weights: the JAX init, moved."""
    cfg = JaxConfig(512, 128, n_layers, d_model, True, True)
    p = jax.tree.map(to_np, jax_init(jax.random.PRNGKey(seed), cfg))
    r = np.random.default_rng(seed + 100)
    p["token_embs"] = p["token_embs"] * np.float32(0.2)
    p["pos_embs"] = r.standard_normal(p["pos_embs"].shape).astype(np.float32)
    for block in p["decoder"]["layers"].values():
        for lin in block.values():
            if isinstance(lin, dict) and "w" in lin:
                lin["w"] = lin["w"] * np.float32(3.0)
    ref = SimpleNamespace(cfg=cfg, params=jax.tree.map(jnp.asarray, p))
    ours = SimpleNamespace(cfg=DecoderLMConfig(512, 128, n_layers, d_model, True, True), params=from_jax_params(p),
                           device=torch.device("cpu"))
    return ref, ours


@pytest.fixture(scope="module")
def models():
    return {"target": _pair(0), "target4": _pair(0, n_layers=4), "random": _pair(7),
            "smaller": _pair(3, n_layers=1, d_model=64)}


def _plain(model, prompt, max_tokens, eos=None):
    return DecoderGenerator(model, Tok(eos)).generate_tokens(prompt, max_tokens=max_tokens)


# (target, draft ("same": the target itself; "truncated": its first 2 layers), k, prompt, max_tokens, eos)
GREEDY = {
    "random_k1": ("target", "random", 1, PROMPT, 24, None),
    "random_k3": ("target", "random", 3, PROMPT, 24, None),
    "random_k4": ("target", "random", 4, PROMPT, 24, None),
    "identical_k4": ("target", "same", 4, PROMPT, 20, None),
    "truncated_k3": ("target4", "truncated", 3, PROMPT, 20, None),
    "smaller_k3": ("target", "smaller", 3, PROMPT, 24, None),
    "eos_k3": ("target", "random", 3, PROMPT, 24, "sixth"),
    "edge_k4": ("target", "same", 4, EDGE_PROMPT, 120, None),
}


def _gens(models, case: str):
    tgt, draft, k, prompt, max_tokens, eos = GREEDY[case]
    (jt, ot) = models[tgt]
    if eos == "sixth":  # the plain run's 6th generated token: both loops stop at its first occurrence
        eos = _plain(ot, prompt, max_tokens)[len(prompt) + 5]
    if draft == "truncated":
        return (JaxSpec.with_truncated_draft(jt, Tok(eos), 2, k=k),
                SpeculativeDecoderGenerator.with_truncated_draft(ot, Tok(eos), 2, k=k), prompt, max_tokens, eos)
    jd, od = (jt, ot) if draft == "same" else models[draft]
    return JaxSpec(jt, jd, Tok(eos), k=k), SpeculativeDecoderGenerator(ot, od, Tok(eos), k=k), prompt, max_tokens, eos


@pytest.fixture(scope="module")
def jax_greedy(models):
    """JAX's tokens and iteration count per case, computed once."""
    out = {}
    for case in GREEDY:
        jgen, _, prompt, max_tokens, _ = _gens(models, case)
        out[case] = (jgen.generate_tokens(prompt, max_tokens=max_tokens), jgen.last_iters)
    return out


@pytest.mark.parametrize("case", list(GREEDY))
def test_greedy_matches_jax_and_plain(models, jax_greedy, case):
    _, gen, prompt, max_tokens, eos = _gens(models, case)
    assert gen.last_iters is None and gen.last_accept_rate is None  # None before the first call
    got = gen.generate_tokens(prompt, max_tokens=max_tokens)
    want, want_iters = jax_greedy[case]
    assert got == want
    assert gen.last_iters == want_iters
    assert -1e-9 <= gen.last_accept_rate <= 1.0 + 1e-9
    base = _plain(gen.model, prompt, max_tokens, eos)
    if case == "edge_k4":  # the loop stops up to k tokens before the context ends
        assert len(base) - gen.k <= len(got) <= len(base) and got == base[:len(got)]
        assert len(got) > 64 + len(prompt)  # past the bucket: the edge write was reached
    else:
        assert got == base
    if eos is not None:
        assert got[-1] == eos and eos not in got[len(prompt):-1]
    else:
        assert len(got) == len(prompt) + max_tokens or case == "edge_k4"  # the budget cap
    if GREEDY[case][1] == "same":  # the draft's one stale slot a fully accepted chunk leaves is JAX's too
        assert gen.last_accept_rate > 0.25


def test_streams_move(jax_greedy):
    out = jax_greedy["random_k3"][0]
    assert len(set(out[len(PROMPT):])) >= 10


def test_truncated_draft_shares_the_target_weights(models):
    _, target = models["target4"]
    dp, dc = spec.truncate_decoder_lm(target.params, target.cfg, 2)
    assert dc.n_layers == 2 and len(dp["decoder"]["layers"]) == 2
    assert dp["decoder"]["layers"][0] is target.params["decoder"]["layers"][0]
    assert dp["decoder"] is not target.params["decoder"] and len(target.params["decoder"]["layers"]) == 4
    extra = dict(target.params, decoder=dict(target.params["decoder"], note=torch.zeros(1)))
    assert "note" in spec.truncate_decoder_lm(extra, target.cfg, 1)[0]["decoder"]  # copied, not replaced


def test_truncated_draft_follows_the_targets_cast():
    """The draft cuts the target's CURRENT weights: ``to_bf16`` or
    ``quantize_int8`` on the target after the draft was made is the draft's
    too (a draft holding a copy of the old tree would stay fp32)."""
    model = GPT2(3, 64, rng=0, device="cpu")
    gen = SpeculativeDecoderGenerator.with_truncated_draft(model, Tok(), 2, k=2)
    assert gen.draft_model.cfg.n_layers == 2 and gen.draft_model.device == model.device
    model.to_bf16()
    draft = gen.draft_model.params
    assert draft["token_embs"].dtype == torch.bfloat16 and draft["token_embs"] is model.params["token_embs"]
    assert all(a is b for a, b in zip(draft["decoder"]["layers"], model.params["decoder"]["layers"][:2]))
    assert len(gen.generate_tokens(PROMPT, max_tokens=6)) == len(PROMPT) + 6  # both models in bf16
    model.quantize_int8()
    assert gen.draft_model.params["decoder"]["layers"][1] is model.params["decoder"]["layers"][1]
    with pytest.raises(ValueError):
        SpeculativeDecoderGenerator.with_truncated_draft(model, Tok(), 4)


@pytest.mark.parametrize("k", [1, 3])
def test_fused_draft_matches_jax(models, jax_greedy, monkeypatch, k):
    """USE_FUSED_STEP = True: the draft's steps go through the fused step's
    plain twin at B = 1 (with its head), once per draft step; the tokens and
    the iteration count stay JAX's."""
    case = {1: "random_k1", 3: "random_k3"}[k]
    calls = []
    real = decode_step.fused_decode_step

    def spy(x, packed, kc, *a, **kw):
        calls.append((kc.shape[1], kw.get("head") is not None))
        return real(x, packed, kc, *a, **kw)

    monkeypatch.setattr(attn, "USE_FUSED_STEP", True)
    monkeypatch.setattr(decode_step, "fused_decode_step", spy)
    _, gen, prompt, max_tokens, _ = _gens(models, case)
    got = gen.generate_tokens(prompt, max_tokens=max_tokens)
    assert got == jax_greedy[case][0] and gen.last_iters == jax_greedy[case][1]
    assert calls == [(1, True)] * (k * gen.last_iters)


def _batch(models, k, draft, eos=None):
    jt, ot = models["target"]
    jd, od = (jt, ot) if draft == "same" else models[draft]
    return JaxSpec(jt, jd, Tok(eos), k=k), SpeculativeDecoderGenerator(ot, od, Tok(eos), k=k)


# (k, draft, eos from the first row's plain run at this generated index, or None)
BATCHED = {"random_k3": (3, "random", None), "random_k4": (4, "random", None), "identical_k4": (4, "same", None),
           "eos_k3": (3, "random", 4)}


@pytest.fixture(scope="module")
def jax_batched(models):
    out = {}
    for case, (k, draft, at) in BATCHED.items():
        eos = None if at is None else _plain(models["target"][1], BATCH[1], 20)[len(BATCH[1]) + at]
        out[case] = (eos, _batch(models, k, draft, eos)[0].generate_tokens_batch(BATCH, max_tokens=20))
    return out


@pytest.mark.parametrize("case", list(BATCHED))
def test_batch_matches_jax_and_one_row(models, jax_batched, case):
    """Per-row prompt lengths, acceptance and positions: each row equals
    JAX's batched row, the port's one-row path and its plain decode; with an
    EOS the rows stop on their own."""
    k, draft, _ = BATCHED[case]
    eos, want = jax_batched[case]
    _, gen = _batch(models, k, draft, eos)
    got = gen.generate_tokens_batch(BATCH, max_tokens=20)
    assert got == want
    assert got == [gen.generate_tokens(p, max_tokens=20) for p in BATCH]
    assert got == [_plain(gen.model, p, 20, eos) for p in BATCH]
    if eos is not None:
        assert got[1][-1] == eos and len(got[1]) < len(BATCH[1]) + 20


def test_batch_parks_rows_at_the_context_edge(models):
    """A row that reaches the context's edge parks while another row runs
    on: every row still equals its one-row run."""
    _, target = models["target"]
    gen = SpeculativeDecoderGenerator(target, target, Tok(), k=4)
    prompts = [EDGE_PROMPT, [2, 7]]
    got = gen.generate_tokens_batch(prompts, max_tokens=120)
    assert got == [gen.generate_tokens(p, max_tokens=120) for p in prompts]


def test_mha_per_row_cache_pos_matches_int_form():
    """A (B,) ``cache_pos`` writes and masks each row as the int form does
    for that row alone, for a chunk (S = 3, the masked plain path) and a
    single position (S = 1: the decode attention's plain version with
    per-row ends), with and without a per-row additive bias."""
    g = torch.Generator().manual_seed(0)
    cfg = tfm.LayerConfig.make(128)
    p = tfm.mha_init(g, cfg)
    b, l_max = 3, 16
    pos = torch.tensor([2, 7, 11])
    for s in (3, 1):
        for biased in (False, True):
            x = torch.randn(b, s, 128, generator=g)
            cache0 = {k: torch.randn(b, l_max, 128, generator=g) for k in ("k", "v")}
            bias = torch.randn(b, cfg.n_heads, s, l_max, generator=g) if biased else None
            rows = {k: v.clone() for k, v in cache0.items()}
            with torch.inference_mode():
                old = attn.USE_DECODE_KERNEL
                attn.USE_DECODE_KERNEL = True  # S = 1: the decode kernel's wrapper (its plain version on the CPU)
                try:
                    out, _ = tfm.mha_apply(p, cfg, x, attn_bias=bias, cache=rows, cache_pos=pos)
                finally:
                    attn.USE_DECODE_KERNEL = old
                for r in range(b):
                    one = {k: v[r:r + 1].clone() for k, v in cache0.items()}
                    want, _ = tfm.mha_apply(p, cfg, x[r:r + 1], attn_bias=None if bias is None else bias[r],
                                            cache=one, cache_pos=int(pos[r]))
                    torch.testing.assert_close(out[r:r + 1], want, rtol=1e-5, atol=1e-5)
                    for k in ("k", "v"):  # the chunk at row r's own slots, every other slot untouched
                        torch.testing.assert_close(rows[k][r], one[k][0], rtol=1e-6, atol=1e-6)
                        kept = torch.ones(l_max, dtype=torch.bool)
                        kept[int(pos[r]):int(pos[r]) + s] = False
                        assert torch.equal(rows[k][r][kept], cache0[k][r][kept])


# ---------------------------------------------------------------- sampling


def _oracle(model, prompt, max_tokens, seed, topk, top_p, temperature, row=0):
    """A positional plain sampler: a full re-forward a token, each token
    drawn on the draft stream at its absolute position."""
    seq = list(prompt)
    limit = min(len(prompt) + max_tokens, model.cfg.max_seq_len)
    rows = torch.tensor([row])
    with torch.inference_mode():
        while len(seq) < limit:
            lg = decoder_lm_apply(model.params, model.cfg, torch.tensor([seq]))[:, -1]
            p = spec._filtered_probs(lg, topk, top_p, temperature)
            u = spec._stream_uniforms(seed, spec.DRAFT, rows, torch.tensor([[len(seq)]]))[:, 0]
            seq.append(int(spec._sample_probs(p, u)[0]))
    return seq


@pytest.mark.parametrize("fused", [False, True], ids=["per_op", "fused_draft"])
@pytest.mark.parametrize("setting", range(len(SAMPLINGS)))
@pytest.mark.parametrize("k", [2, 4])
def test_identity_draft_equals_positional_sampler(models, monkeypatch, setting, fused, k):
    """Draft == target accepts every draft (p/q = 1), so one iteration (k
    drafts and the bonus, a budget of k + 1) is the positional plain
    sampler's stream: the draft stream's draws, the accept path, the bonus
    draw and the buffers (the fused draft: the headless twin, then the tied
    head). Over later iterations a draft equal to the target is no identity:
    a fully accepted chunk leaves the draft's slot ``pos+k-1`` unfilled (the
    JAX package's cache, kept), so q parts from p."""
    monkeypatch.setattr(attn, "USE_FUSED_STEP", fused)
    _, target = models["target"]
    kw = SAMPLINGS[setting]
    for prompt in (PROMPT, BATCH[2]):
        got = SpeculativeDecoderGenerator(target, target, Tok(), k=k).generate_tokens(prompt, k + 1, seed=11, **kw)
        assert got == _oracle(target, prompt, k + 1, 11, **kw)


def test_random_draft_stays_in_the_targets_top_k(models):
    _, target = models["target"]
    _, draft = models["random"]
    topk = 6
    out = SpeculativeDecoderGenerator(target, draft, Tok(), k=4).generate_tokens(PROMPT, 24, topk=topk, seed=3)
    assert len(out) == len(PROMPT) + 24
    with torch.inference_mode():
        for t in range(len(PROMPT), len(out)):
            lg = decoder_lm_apply(target.params, target.cfg, torch.tensor([out[:t]]))[0, -1]
            assert out[t] in lg.topk(topk).indices.tolist(), f"token at {t} outside the target's top-{topk}"


FILTERINGS = SAMPLINGS + [dict(topk=1, top_p=0.6, temperature=1.0), dict(topk=5, top_p=0.8, temperature=0.5),
                          dict(topk=512, top_p=None, temperature=2.0)]


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("setting", range(len(FILTERINGS)))
def test_filtered_probs_match_jax(setting, tied):
    """The port's filtered distribution (temperature, then the top k with
    ties to the lower id, then the nucleus, then the softmax; topk == 1
    meaning nucleus only) is the JAX package's, probability by probability,
    also where tied logits straddle the top-k and nucleus cuts."""
    r = np.random.default_rng(setting)
    logits = (r.standard_normal((6, 512)) * 3).astype(np.float32)
    if tied:  # a coarse grid: runs of equal logits, some of them across the cut
        logits = np.round(logits * 2).astype(np.float32) / 2
    kw = FILTERINGS[setting]
    want = np.asarray(jax_spec._filtered_probs(jnp.asarray(logits), kw["topk"], kw["top_p"], kw["temperature"]))
    got = spec._filtered_probs(torch.from_numpy(logits), kw["topk"], kw["top_p"], kw["temperature"]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.array_equal(got > 0, want > 0)  # the same kept set


def _accept_trials(q, p, n: int):
    """The first emitted token of ``n`` independent trials (one row of
    counters each) of the rejection core on the rows ``q`` (k, V), ``p``
    (k+1, V), drafts drawn from q on the draft stream."""
    k, v = q.shape
    rows = torch.arange(n)
    qb, pb = q.expand(n, k, v), p.expand(n, k + 1, v)
    at = torch.arange(k).expand(n, k)
    drafts = spec._sample_probs(qb, spec._stream_uniforms(5, spec.DRAFT, rows, at + 1))
    n_acc, corr = spec._accept_and_correct(qb, pb, drafts, 1, 5, rows)
    return drafts, n_acc, corr


def test_accept_and_correct_is_distribution_exact():
    """Empirical first emitted token == p_0 under a mismatched draft (total
    variation < 1% at 40k trials; sampling noise alone is ~0.5%)."""
    k, v = 3, 12
    r = np.random.default_rng(0)
    q = torch.from_numpy(r.dirichlet(np.ones(v) * 0.4, size=k).astype(np.float32))
    p = torch.from_numpy(r.dirichlet(np.ones(v) * 0.8, size=k + 1).astype(np.float32))
    drafts, n_acc, corr = _accept_trials(q, p, 40_000)
    first = torch.where(n_acc > 0, drafts[:, 0], corr)
    emp = np.bincount(first.numpy(), minlength=v) / 40_000
    assert 0.5 * np.abs(emp - p[0].numpy()).sum() < 0.01


def test_accept_and_correct_all_accept_bonus_from_p_k():
    """q == p: nothing is rejected and the bonus is drawn from p_k."""
    k, v = 2, 10
    rows = torch.from_numpy(np.random.default_rng(1).dirichlet(np.ones(v), size=k + 1).astype(np.float32))
    _, n_acc, corr = _accept_trials(rows[:k], rows, 20_000)
    assert int(n_acc.min()) == k
    emp = np.bincount(corr.numpy(), minlength=v) / 20_000
    assert 0.5 * np.abs(emp - rows[k].numpy()).sum() < 0.015


def test_greedy_arguments_route_to_exact_greedy(models, jax_greedy):
    _, gen, prompt, max_tokens, _ = _gens(models, "random_k3")
    assert gen.generate_tokens(prompt, max_tokens, topk=1, seed=5) == jax_greedy["random_k3"][0]


def test_sampled_batch_rows_reproduce_one_row_runs(models):
    """Batched row r draws row r's counters: with the identity draft over
    one iteration it is the positional sampler as row r; with a random draft
    row 0 is the one-row call and row r the one-row loop run as row r."""
    _, target = models["target"]
    _, draft = models["random"]
    kw = dict(topk=8, temperature=0.9)
    same = SpeculativeDecoderGenerator(target, target, Tok(), k=3).generate_tokens_batch(BATCH, 4, seed=11, **kw)
    assert same == [_oracle(target, p, 4, 11, 8, None, 0.9, row=r) for r, p in enumerate(BATCH)]
    gen = SpeculativeDecoderGenerator(target, draft, Tok(), k=3)
    got = gen.generate_tokens_batch(BATCH, 12, seed=11, **kw)
    assert got[0] == gen.generate_tokens(BATCH[0], 12, seed=11, **kw)
    for r, prompt in enumerate(BATCH):
        buf = torch.zeros((1, 64), dtype=torch.int64)
        buf[0, :len(prompt)] = torch.tensor(prompt)
        out, lengths, _ = spec._spec_generate(target.params, target.cfg, draft.params, draft.cfg, buf, len(prompt),
                                              len(prompt) + 12, 3, -1, (8, None, 0.9, 11), row=r)
        assert got[r] == out[0, : lengths[0]].tolist()


def test_entry_points(models):
    _, target = models["target"]
    _, draft = models["random"]
    gen = SpeculativeDecoderGenerator(target, draft, Tok(), k=2)
    assert len(gen.generate("x", max_tokens=6).split()) == len(PROMPT) + 6
    assert gen.generate_batch(["x", "y"], max_tokens=4) == [gen.generate("x", max_tokens=4)] * 2
    assert gen.generate_tokens(PROMPT, max_tokens=0) == PROMPT
    with pytest.raises(ValueError):
        SpeculativeDecoderGenerator(target, draft, Tok(), k=0)
    with pytest.raises(ValueError):
        gen.generate_tokens(PROMPT, 4, topk=0)
