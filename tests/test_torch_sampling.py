"""Sampled generation in the PyTorch port vs the JAX package, on the CPU.

The port's sampler draws ONE uniform per row per step from a
``torch.Generator`` and picks by inverse CDF; the JAX package draws Gumbel
noise from its own PRNG. The streams cannot match, so the sampler is held
to JAX by distribution: both libraries' draws at three (topk, top_p,
temperature) settings pass a chi-square test against the renormalised
probabilities computed here in float64, and each other's counts. Exact
checks: the nucleus mask against JAX's, the support of every draw, the
greedy limits (``topk=1``, tiny ``top_p``) against JAX's greedy tokens.
Generation: same seed, same stream; shared-prefill samples equal to the
batch over n copies; rows stop at EOS on their own; every route (the fused
step's plain twin forced on, the per-op kernel wrappers, plain) on both
sides of the fused step's 32 rows gives the same tokens. Also the K4 gate's
decisions (``use_greedy_head``) with the device check patched.

A small GPT-2 (2 layers, d_model 64, one head, vocab 300, context 128) is
loaded in the JAX package from a synthetic HF state dict and bridged into
the port; its weights (token embeddings 0.3, position embeddings 1.0,
matrices 0.3) make the greedy streams move and the sampled distribution
broad (top-1 about 0.15, top-40 mass about 0.86).
"""

from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import pytorch_models_tpu.models.text as jax_text
from pytorch_models_tpu.models.text import generator as jax_gen
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.models.text import GPT2, DecoderGenerator
from pytorch_models_tpu_torch.models.text import generator as gen_mod
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.ops import decode_step, gather
from pytorch_models_tpu_torch.utils import from_jax_params

torch.set_num_threads(1)

VOCAB, CTX, N_LAYERS, D = 300, 128, 2, 64
PROMPT = [3, 1, 4, 1, 5]
PROMPTS = [[3, 1, 4], [2, 7, 1, 8, 2, 8], [5], list(range(20, 41))]
N_DRAWS = 20_000
P_MIN = 1e-3  # chi-square p-value floor
SETTINGS = [dict(topk=40, top_p=None, temperature=1.0), dict(topk=1, top_p=0.9, temperature=0.8),
            dict(topk=40, top_p=0.9, temperature=0.8)]


class Tok:
    def __init__(self, eos=None):
        self.eos_token_id = eos


def hf_state_dict(seed=7, vocab=VOCAB, ctx=CTX, d=D, n_layers=N_LAYERS, wte=0.3, wpe=1.0, w=0.3):
    """Synthetic HF GPT-2 weights (also used by tests/test_torch_beam.py)."""
    r = np.random.default_rng(seed)

    def rn(*shape, s=0.02):
        return (r.standard_normal(shape) * s).astype(np.float32)

    sd = {"wte.weight": rn(vocab, d, s=wte), "wpe.weight": rn(ctx, d, s=wpe), "ln_f.weight": 1 + rn(d),
          "ln_f.bias": rn(d)}
    for i in range(n_layers):
        p = f"h.{i}"
        sd |= {f"{p}.ln_1.weight": 1 + rn(d), f"{p}.ln_1.bias": rn(d), f"{p}.ln_2.weight": 1 + rn(d),
               f"{p}.ln_2.bias": rn(d), f"{p}.attn.c_attn.weight": rn(d, 3 * d, s=w),
               f"{p}.attn.c_attn.bias": rn(3 * d), f"{p}.attn.c_proj.weight": rn(d, d, s=w),
               f"{p}.attn.c_proj.bias": rn(d), f"{p}.mlp.c_fc.weight": rn(d, 4 * d, s=w),
               f"{p}.mlp.c_fc.bias": rn(4 * d), f"{p}.mlp.c_proj.weight": rn(4 * d, d, s=w),
               f"{p}.mlp.c_proj.bias": rn(d)}
    return sd


def small_gpt2_pair(**sd_kw):
    """(JAX GPT2, port GPT2 on the CPU) over the same synthetic weights."""

    def small(cls, **kw):
        old = (cls.vocab_size, cls.max_seq_len)
        cls.vocab_size, cls.max_seq_len = VOCAB, CTX
        try:
            return cls(N_LAYERS, D, **kw)
        finally:
            cls.vocab_size, cls.max_seq_len = old

    ref = small(jax_text.GPT2)
    ref.load_hf_state_dict(hf_state_dict(**sd_kw))
    ours = small(GPT2, device="cpu")
    ours.params = from_jax_params(jax.tree.map(to_np, ref.params))
    return ref, ours


@pytest.fixture(scope="module")
def models():
    return small_gpt2_pair()


ROUTES = {"fused": (True, True), "per-op": (True, False), "plain": (False, False)}


@pytest.fixture()
def route(request, monkeypatch):
    """Sets the dispatch flags of ``request.param`` and counts the fused
    step's plain-twin calls without a head: ``fused`` forces
    ``USE_FUSED_STEP`` (on CPU tensors the wrapper runs the twin) with the
    kernel wrappers on; ``per-op`` the kernel wrappers without the fused
    step; ``plain`` every flag False."""
    kernels, fused = ROUTES[request.param]
    for mod, name in ((attn, "USE_DECODE_KERNEL"), (attn, "USE_ENCODER_KERNEL"), (attn, "USE_GREEDY_HEAD"),
                      (gather, "USE_GATHER_KERNEL")):
        monkeypatch.setattr(mod, name, kernels)
    monkeypatch.setattr(attn, "USE_FUSED_STEP", fused)
    calls = {"headless": 0, "head": 0}
    real = decode_step.fused_decode_step

    def spy(*args, **kw):
        calls["headless" if kw.get("head") is None else "head"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(decode_step, "fused_decode_step", spy)
    return request.param, calls


def _logits(seed, v=VOCAB, scale=1.5):
    return (np.random.default_rng(seed).standard_normal(v) * scale).astype(np.float32)


def _expected(logits, topk, top_p, temperature):
    """float64 probabilities of each token under the sampler's rule: the top
    k of the scaled logits (ties to the lower index), then the nucleus."""
    scaled = logits.astype(np.float64) / temperature
    k = topk if topk > 1 else len(logits)
    order = np.argsort(-scaled, kind="stable")[:k]
    p = np.exp(scaled[order] - scaled[order].max())
    p /= p.sum()
    if top_p is not None:
        p = np.where(np.cumsum(p) - p < top_p, p, 0.0)
        p /= p.sum()
    out = np.zeros(len(logits))
    out[order] = p
    return out


def _chi2(counts, expected_p):
    """p-value of the counts against ``expected_p``; bins expecting fewer
    than 5 draws merged into one."""
    exp = expected_p * counts.sum()
    big = exp >= 5
    obs, want = list(counts[big]), list(exp[big])
    if (~big & (expected_p > 0)).any():
        obs.append(counts[~big].sum())
        want.append(exp[~big].sum())
    assert counts[expected_p == 0].sum() == 0
    return stats.chisquare(obs, want).pvalue


@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.9, 0.99])
@pytest.mark.parametrize("seed", [0, 1])
def test_nucleus_mask_matches_jax(top_p, seed):
    vals = np.sort(_logits(seed))[::-1].copy()
    got = gen_mod._nucleus_mask(torch.from_numpy(vals), top_p).numpy()
    ref = np.asarray(jax_gen._nucleus_mask(jnp.asarray(vals), top_p))
    probs = np.exp(vals.astype(np.float64) - vals.max())
    probs /= probs.sum()
    near = np.abs(np.cumsum(probs) - probs - top_p) <= 1e-6  # fp32 summation order may decide these
    keep_got, keep_ref = got > np.finfo(np.float32).min, ref > np.finfo(np.float32).min
    assert keep_got[0] and keep_got.sum() < len(vals)
    np.testing.assert_array_equal(keep_got[~near], keep_ref[~near])
    np.testing.assert_array_equal(got[keep_got], vals[keep_got])


@pytest.mark.parametrize("setting", SETTINGS, ids=["topk40", "top_p0.9_T0.8", "topk40_top_p0.9_T0.8"])
def test_draws_follow_the_distribution_as_jax_does(setting):
    logits = _logits(11)
    order = np.argsort(-logits, kind="stable")
    a, b = sorted(order[100:102])  # two tokens below the top 40, moved to tie for the 40th place
    logits[[a, b]] = (logits[order[38]] + logits[order[39]]) / 2
    want = _expected(logits, **setting)
    rows = torch.from_numpy(logits).expand(N_DRAWS, -1)
    ours = gen_mod._sample(rows, torch.Generator().manual_seed(0), **setting).numpy()
    theirs = np.asarray(jax_gen._sample(jnp.asarray(np.broadcast_to(logits, (N_DRAWS, VOCAB))),
                                        jax.random.PRNGKey(0), **setting))
    for draws in (ours, theirs):
        assert set(np.unique(draws)) <= set(np.flatnonzero(want > 0))  # exact support
        assert _chi2(np.bincount(draws, minlength=VOCAB), want) > P_MIN
    both = np.stack([np.bincount(ours, minlength=VOCAB), np.bincount(theirs, minlength=VOCAB)])
    both = both[:, both.sum(0) >= 10]
    assert stats.chi2_contingency(both).pvalue > P_MIN
    if setting["topk"] == 40 and setting["top_p"] is None:  # the lower index of the tie is in the set
        assert want[a] > 0 and want[b] == 0


def test_sample_is_one_uniform_per_row():
    """Every setting draws exactly B uniforms a call (the routes stay in step),
    and greedy draws none."""
    logits = torch.from_numpy(np.stack([_logits(s) for s in range(5)]))
    for setting in SETTINGS:
        g, ref = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
        gen_mod._sample(logits, g, **setting)
        torch.rand((5,), generator=ref)
        assert torch.equal(torch.rand(4, generator=g), torch.rand(4, generator=ref))
    g = torch.Generator().manual_seed(3)
    assert torch.equal(gen_mod._sample(logits, g, 1), logits.argmax(-1))
    assert torch.equal(torch.rand(4, generator=g), torch.rand(4, generator=torch.Generator().manual_seed(3)))


def test_greedy_limits_give_jax_greedy_tokens(models):
    ref, ours = models
    expected = jax_text.DecoderGenerator(ref, Tok()).generate_tokens_batch(PROMPTS, max_tokens=12)
    gen = DecoderGenerator(ours, Tok())
    assert gen.generate_tokens_batch(PROMPTS, max_tokens=12, topk=1) == expected
    assert gen.generate_tokens_batch(PROMPTS, max_tokens=12, top_p=1e-6, seed=5) == expected
    assert gen.generate_tokens(PROMPTS[1], max_tokens=12, topk=1, top_p=1e-6) == expected[1]
    assert min(len(set(row[-12:])) for row in expected) >= 4  # the streams move


def test_seed_fixes_the_stream(models):
    _, ours = models
    gen = DecoderGenerator(ours, Tok())
    runs = {s: gen.generate_tokens_batch(PROMPTS, max_tokens=16, topk=40, top_p=0.9, temperature=0.8, seed=s)
            for s in (0, 0, 1, 2)}
    again = gen.generate_tokens_batch(PROMPTS, max_tokens=16, topk=40, top_p=0.9, temperature=0.8, seed=0)
    assert runs[0] == again
    assert len({str(v) for v in runs.values()}) == 3
    assert gen.generate_tokens(PROMPT, max_tokens=16, topk=40, seed=4) == \
        gen.generate_tokens(PROMPT, max_tokens=16, topk=40, seed=4)


@pytest.mark.parametrize("kw", [dict(topk=8), dict(topk=1, top_p=0.9), dict(topk=16, temperature=0.7),
                                dict(topk=40, top_p=0.9, temperature=0.8)])
def test_samples_equal_batched_copies(models, kw):
    """As tests/text/test_samples.py: n samples of ONE prompt equal
    ``generate_tokens_batch`` over n copies with the same seed."""
    _, ours = models
    gen = DecoderGenerator(ours, Tok())
    batch = gen.generate_tokens_batch([PROMPT] * 3, max_tokens=16, seed=11, **kw)
    assert gen.generate_tokens_samples(PROMPT, 3, max_tokens=16, seed=11, **kw) == batch
    assert len({tuple(row) for row in batch}) > 1  # the rows draw on their own


def test_samples_rows_stop_at_eos_on_their_own(models):
    _, ours = models
    base = DecoderGenerator(ours, Tok()).generate_tokens_samples(PROMPT, 6, max_tokens=20, topk=32, seed=5)
    g0 = base[0][len(PROMPT):]
    first = next(i for i in range(4, len(g0)) if g0[i] not in g0[:i])  # a token row 0 first draws at step >= 4
    eos = g0[first]
    gen = DecoderGenerator(ours, Tok(eos))
    samples = gen.generate_tokens_samples(PROMPT, 6, max_tokens=20, topk=32, seed=5)
    assert samples == gen.generate_tokens_batch([PROMPT] * 6, max_tokens=20, topk=32, seed=5)
    for row, full in zip(samples, base):
        cut = full.index(eos, len(PROMPT)) + 1 if eos in full[len(PROMPT):] else len(full)
        assert row == full[:cut]
    assert len(samples[0]) == len(PROMPT) + first + 1
    assert len({len(row) for row in samples}) > 1


@pytest.mark.parametrize("route", list(ROUTES), indirect=True)
@pytest.mark.parametrize("n", [4, 12, 36])
def test_every_route_draws_the_same_samples(models, route, n):
    """fused (the headless step's twin), per-op and plain: the same tokens
    on both sides of one fused launch's 32 rows (MAX_LAUNCH_ROWS; above
    them the card runs the kernel over row slices), sampled and greedy."""
    name, calls = route
    _, ours = models
    gen = DecoderGenerator(ours, Tok())
    kw = dict(max_tokens=10, topk=40, top_p=0.9, temperature=0.8, seed=0)
    samples = gen.generate_tokens_samples(PROMPT, n, **kw)
    batch = gen.generate_tokens_batch((PROMPTS * 9)[:n], **kw)
    greedy = gen.generate_tokens_samples(PROMPT, n, max_tokens=10, topk=1)
    with _plain_route():
        assert samples == gen.generate_tokens_samples(PROMPT, n, **kw)
        assert batch == gen.generate_tokens_batch((PROMPTS * 9)[:n], **kw)
        assert greedy == gen.generate_tokens_samples(PROMPT, n, max_tokens=10, topk=1)
    fused_here = name == "fused"
    assert (calls["headless"] == 2 * 9) if fused_here else calls["headless"] == 0  # one a decode step, two calls
    assert (calls["head"] == 9) if fused_here else calls["head"] == 0


@contextmanager
def _plain_route():
    """Every dispatch flag False inside the block."""
    flags = [(attn, "USE_FUSED_STEP"), (attn, "USE_DECODE_KERNEL"), (attn, "USE_ENCODER_KERNEL"),
             (attn, "USE_GREEDY_HEAD"), (gather, "USE_GATHER_KERNEL")]
    saved = [getattr(mod, name) for mod, name in flags]
    for mod, name in flags:
        setattr(mod, name, False)
    try:
        yield
    finally:
        for (mod, name), v in zip(flags, saved):
            setattr(mod, name, v)


def test_invalid_args_raise(models):
    """The arguments tests/text/test_sampling.py:106 has the JAX package
    refuse (there by assert, here by ValueError)."""
    _, ours = models
    gen = DecoderGenerator(ours, Tok())
    for kw in (dict(top_p=0.0), dict(top_p=1.5), dict(temperature=0.0), dict(topk=0)):
        with pytest.raises(ValueError):
            gen.generate_tokens([1], max_tokens=4, **kw)
        with pytest.raises(ValueError):
            gen.generate_tokens_batch([[1]], max_tokens=4, **kw)
        with pytest.raises(ValueError):
            gen.generate_tokens_samples([1], 2, max_tokens=4, **kw)
        with pytest.raises(AssertionError):
            jax_gen._check_sampling(kw.get("topk", 1), kw.get("top_p"), kw.get("temperature", 1.0))
    with pytest.raises(ValueError):
        gen.generate_tokens_samples([1], 0, max_tokens=4)


@pytest.mark.parametrize("args", [(3, 1, None, 1.0), (3, 40, 0.9, [0.5, 1.0, 2.0]), (2, 1, [0.5, 0.9], 0.7)])
def test_parse_sampling_params_matches_jax(args):
    assert gen_mod._parse_sampling_params(*args) == jax_gen._parse_sampling_params(*args)
    with pytest.raises(ValueError):
        gen_mod._parse_sampling_params(args[0] + 1, 1, [0.5] * args[0], 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tied", [True, False])
def test_greedy_head_gate_takes_the_faster_side(monkeypatch, dtype, tied):
    """The K4 auto gate with the device check patched: the kernel from 4
    rows up to the measured crossover (fp32: 16 rows; untied bf16: 32; tied
    bf16: every batch), the head matmul + argmax above it."""
    monkeypatch.setattr(attn, "USE_GREEDY_HEAD", None)
    monkeypatch.setattr(attn, "_on_cuda", lambda t: True)
    w = torch.zeros((1000, 64) if tied else (64, 1000), dtype=dtype)
    limit = {(torch.float32, True): 16, (torch.float32, False): 16, (torch.bfloat16, False): 32}.get((dtype, tied))
    for b in (2, 16, 17, 32, 33, 64, 200):
        assert attn.use_greedy_head(b, w, tied=tied) == (b >= 4 and (limit is None or b <= limit)), b
