"""Continuous batching (``ContinuousBatchingGenerator``) of the PyTorch port
vs the JAX package's, on the CPU.

A small decoder LM (2 layers, d_model 128, 2 heads of 64, vocab 512,
context 256) from the JAX package's ``decoder_lm_init``, with position
embeddings seeded at scale 3 and layer matrices at 4x the init's, so that
the greedy streams move, bridged into the port through numpy. Two routes on the port's side: per-op (the CPU
default) and fused (``USE_FUSED_STEP = True``: on CPU tensors the fused
step's wrapper runs its plain twin over the whole pool, at any size: on
the card the kernel serves a pool above ``ops.decode_step.MAX_LAUNCH_ROWS``
= 32 rows over row slices; a spy counts its calls and their rows). fp32 throughout; greedy tokens are held identical per request to
the JAX package's engine, to the port's ``DecoderGenerator.generate_tokens``
and across routes.

Sampling: the port draws generated token g of request r by a counter-based
uniform of (seed, r, g), JAX by ``fold_in`` keys; the streams cannot match.
Exactly: a request's stream does not depend on the pool size,
``check_every``, the admission order or the route. By distribution: the
first sampled token of many requests of one prompt, drawn by both engines,
passes a chi-square test against the top-k renormalised probabilities
computed here in float64, as tests/test_torch_sampling.py holds the sampler.

The int8 self-KV pool (``USE_INT8_KV`` with the fused step) is held
token-identical to the JAX package's int8 pool, run as
tests/text/test_int8_kv_continuous.py runs it (its kernel in interpret
mode, context 128).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from scipy import stats

import pytorch_models_tpu.ops.attention as jax_attn
from pytorch_models_tpu.models.text import _decoder_lm as jax_dlm
from pytorch_models_tpu.text import ContinuousBatchingGenerator as JaxCB
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.models.text import _decoder_lm as dlm
from pytorch_models_tpu_torch.models.text import continuous as cb_mod
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.ops import decode_step as ds
from pytorch_models_tpu_torch.text import ContinuousBatchingGenerator, DecoderGenerator
from pytorch_models_tpu_torch.utils import from_jax_params

torch.set_num_threads(1)

VOCAB, N_LAYERS, D = 512, 2, 128
P_MIN = 1e-3  # chi-square p-value floor


class Tok:
    def __init__(self, eos=-1):
        self.eos_token_id = eos

    def encode(self, s):
        return [ord(c) % VOCAB for c in s]

    def decode(self, ids):
        return " ".join(map(str, ids))


def _pair(seed=0, max_seq_len=256):
    """(JAX model, port model) over the same weights."""
    jcfg = jax_dlm.DecoderLMConfig(vocab_size=VOCAB, max_seq_len=max_seq_len, n_layers=N_LAYERS, d_model=D,
                                   pre_norm=True, final_norm=True)
    jp = jax_dlm.decoder_lm_init(jax.random.PRNGKey(seed), jcfg)
    r = np.random.default_rng(seed)
    jp["pos_embs"] = jnp.asarray(3.0 * r.standard_normal((max_seq_len, D)).astype(np.float32))
    jp["decoder"]["layers"] = {blk: {name: dict(lin, w=4.0 * lin["w"]) if "w" in lin else lin
                                     for name, lin in sub.items()} if blk in ("sa", "mlp") else sub
                               for blk, sub in jp["decoder"]["layers"].items()}
    cfg = dlm.DecoderLMConfig(vocab_size=VOCAB, max_seq_len=max_seq_len, n_layers=N_LAYERS, d_model=D,
                              pre_norm=True, final_norm=True)
    ours = from_jax_params(jax.tree.map(to_np, jp))
    return SimpleNamespace(cfg=jcfg, params=jp), SimpleNamespace(cfg=cfg, params=ours, device=torch.device("cpu"))


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def small():
    """Context 64: budgets that overflow it force epoch resets."""
    return _pair(seed=3, max_seq_len=64)


ROUTES = ("per-op", "fused")


@pytest.fixture()
def route(request, monkeypatch):
    """``fused`` forces the port's USE_FUSED_STEP (the twin on CPU tensors);
    returns the rows of every fused step called (spied on the module the
    engine imports them from)."""
    rows = []
    monkeypatch.setattr(attn, "USE_FUSED_STEP", request.param == "fused")
    real = ds.fused_decode_step

    def spy(*args, **kw):
        rows.append(args[2].shape[1])
        return real(*args, **kw)

    monkeypatch.setattr(ds, "fused_decode_step", spy)
    return request.param, rows


def _plain(model, requests, budgets, eos=-1, prefix=()):
    """The oracle: the port's generate_tokens per request on the per-op route
    (no bucket padding: the budget is min(n + max_tokens, context), the
    engine's clamp), whatever route the test set."""
    gen = DecoderGenerator(model, Tok(eos))
    flag, attn.USE_FUSED_STEP = attn.USE_FUSED_STEP, False
    try:
        return [gen.generate_tokens(list(prefix) + r, max_tokens=m) for r, m in zip(requests, budgets)]
    finally:
        attn.USE_FUSED_STEP = flag


def _requests(n, seed, lo=1, hi=30):
    r = np.random.default_rng(seed)
    return [r.integers(0, VOCAB, int(r.integers(lo, hi + 1))).tolist() for _ in range(n)]


N_REQ = 40
REQS = _requests(N_REQ, 11)
BUDGETS = [int(b) for b in np.random.default_rng(12).integers(3, 26, N_REQ)]


@pytest.fixture(scope="module")
def greedy_refs(pair):
    """The plain generator's outputs and the JAX engine's at a pool of 8."""
    jm, om = pair
    plain = _plain(om, REQS, BUDGETS)
    jax_out = JaxCB(jm, Tok(), batch_size=8, prompt_bucket=16, check_every=4).generate_tokens_many(REQS, BUDGETS)
    assert jax_out == plain
    assert sum(len(set(o[len(r):])) for o, r in zip(plain, REQS)) >= 2 * N_REQ  # the streams move
    return plain, jax_out


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("pool", [1, 8, 12, 32, 40])
def test_greedy_pool_matches_jax_and_plain(pair, greedy_refs, route, pool):
    """40 requests of 1-30 tokens, budgets 3-25: mid-flight admissions into
    stale slots; every request token-identical to the JAX engine's and to
    the plain generator's. On the fused route every step is one call of
    the fused step over the whole pool (its twin above 8 rows too, and
    above one launch's 32 rows: 40 slots hold every request, as the JAX
    engine's 40 do)."""
    name, rows = route
    _, om = pair
    cb = ContinuousBatchingGenerator(om, Tok(), batch_size=pool, prompt_bucket=16, check_every=4)
    outs = cb.generate_tokens_many(REQS, BUDGETS)
    plain, jax_out = greedy_refs
    assert outs == plain == jax_out
    st = cb.last_stats
    if name == "fused":
        assert len(rows) == st.decode_steps and set(rows) == {pool}
    else:
        assert rows == []
    if pool in (12, 32, 40):
        jm, _ = pair
        n = N_REQ if pool == 40 else 12
        assert JaxCB(jm, Tok(), batch_size=pool, prompt_bucket=16,
                     check_every=4).generate_tokens_many(REQS[:n], BUDGETS[:n]) == outs[:n]


# (name, model fixture, requests, budgets, kw of the engine, prefix, eos from the plain stream of request 0)
SCENARIOS = {
    "eos": ("pair", REQS[:6], [24, 8, 24, 8, 12, 20], dict(batch_size=2, check_every=3), (), 4),
    "epoch_reset": ("small", REQS[:5], [30] * 5, dict(batch_size=2, check_every=8), (), None),
    "chunked_prefill": ("pair", [[7] + list(range(37)), [3, 1, 4], [i * 7 % 512 for i in range(1, 50)],
                                 [i * 3 % 512 for i in range(17)]], [9, 12, 5, 7],
                        dict(batch_size=2, check_every=4), (), None),
    "chunked_prefix": ("pair", [list(range(2, 40)), [8, 1], [i % 509 for i in range(21)]], [7, 11, 6],
                       dict(batch_size=2, check_every=3), (5, 9, 2, 4, 4, 1, 3), None),
    "chunked_epoch_reset": ("pair", [[1, 2, 3], [i % 512 for i in range(100)], [4, 5]], [60, 40, 30],
                            dict(batch_size=2, check_every=5), (), None),
    "shared_prefix": ("pair", REQS[:6], [15, 5, 23, 9, 3, 17], dict(batch_size=2, check_every=4),
                      (7, 3, 9, 1, 4, 4, 2), None),
    "long_prefix": ("pair", REQS[:3], [9, 12, 7], dict(batch_size=2, check_every=4),
                    tuple((i * 37) % 512 for i in range(45)), None),
    "prefix_epoch_reset": ("small", [[3, 1, 4, 1, 5], [2, 7], [9, 2, 6, 5, 3, 5, 8, 9], [11]], [20, 20, 20, 20],
                           dict(batch_size=2, check_every=8), (5, 8, 13, 21, 34), None),
    "near_max_seq_len": ("pair", [[i % 512 for i in range(200)], [5, 6, 7]], [10, 40],
                         dict(batch_size=2, prompt_bucket=64, check_every=4), (), None),
    "single_slot": ("pair", REQS[:3], [7, 11, 5], dict(batch_size=1, check_every=5), (), None),
}


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_matches_plain(request, route, scenario):
    """The JAX package's scenarios (tests/text/test_continuous.py): EOS
    freeing slots early, epoch resets, chunked prefill of prompts longer
    than the bucket (with and without a prefix, across a reset), a shared
    prefix pasted into stale slots, a prefix longer than the bucket, a long
    prompt near the context, a single slot; token-identical to the plain
    generator on prefix + request."""
    fixture, reqs, budgets, kw, prefix, eos_at = SCENARIOS[scenario]
    jm, om = request.getfixturevalue(fixture)
    eos = -1
    if eos_at is not None:  # an EOS id that request 0 emits as its 5th generated token
        base = _plain(om, reqs[:1], [budgets[0]], prefix=prefix)[0]
        eos = base[len(prefix) + len(reqs[0]) + eos_at]
    kw = dict(dict(prompt_bucket=16), **kw)
    cb = ContinuousBatchingGenerator(om, Tok(eos), **kw)
    outs = cb.generate_tokens_many(reqs, budgets, shared_prefix=list(prefix) or None)
    assert outs == _plain(om, reqs, budgets, eos, prefix)
    if eos_at is not None:
        assert outs[0][-1] == eos and len(outs[0]) < len(prefix) + len(reqs[0]) + budgets[0]
    if scenario in ("epoch_reset", "prefix_epoch_reset"):
        assert cb.last_stats.epoch_resets >= 1


def test_text_api_and_limits(pair):
    jm, om = pair
    tok = Tok()
    cb = ContinuousBatchingGenerator(om, tok, batch_size=4, prompt_bucket=16)
    plain = DecoderGenerator(om, tok)
    assert cb.generate_many(["abc", "defg"], max_tokens=6) == [plain.generate(p, max_tokens=6) for p in ["abc", "defg"]]
    assert cb.generate_many(["ab", "cde"], max_tokens=6, shared_prefix="sys: ") == \
        JaxCB(jm, tok, batch_size=2, prompt_bucket=16).generate_many(["ab", "cde"], max_tokens=6,
                                                                      shared_prefix="sys: ")
    assert cb.generate_tokens_many([], 8) == []
    with pytest.raises(ValueError, match="fresh epoch"):
        ContinuousBatchingGenerator(om, tok, batch_size=2, prompt_bucket=8).generate_tokens_many([[1] * 256], 4)
    with pytest.raises(ValueError, match="fresh epoch"):
        ContinuousBatchingGenerator(om, tok, batch_size=2, prompt_bucket=64).generate_tokens_many([[1] * 4], 10_000)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_streaming_callback_delivers_every_token_once(pair, route):
    """on_tokens: each generated token once, in order, at scheduling-point
    granularity; with sampling and a prefix too."""
    _, om = pair
    reqs, budgets = REQS[:5], [11, 4, 17, 7, 9]
    streams, calls = {i: [] for i in range(5)}, []
    cb = ContinuousBatchingGenerator(om, Tok(), batch_size=2, prompt_bucket=16, check_every=4)
    outs = cb.generate_tokens_many(reqs, budgets, on_tokens=lambda r, ts: (streams[r].extend(ts),
                                                                           calls.append(len(ts))))
    assert outs == _plain(om, reqs, budgets)
    assert all(streams[i] == o[len(q):] for i, (q, o) in enumerate(zip(reqs, outs)))
    assert all(1 <= n <= 4 for n in calls)
    prefix, streams = [7, 3, 9], {i: [] for i in range(3)}
    outs = cb.generate_tokens_many(reqs[:3], 8, shared_prefix=prefix, topk=4, seed=9,
                                   on_tokens=lambda r, ts: streams[r].extend(ts))
    assert all(streams[i] == o[len(prefix) + len(q):] for i, (q, o) in enumerate(zip(reqs, outs)))


def test_serving_stats_consistency(small):
    _, om = small
    reqs = [[1, 2, 3], [i % 512 for i in range(14)], [4, 5], [6] * 7]
    cb = ContinuousBatchingGenerator(om, Tok(), batch_size=2, prompt_bucket=16, check_every=5)
    outs = cb.generate_tokens_many(reqs, [30, 30, 30, 10])
    st = cb.last_stats
    assert st.requests == st.admissions == len(reqs)
    assert st.tokens_generated == sum(len(o) - len(r) for o, r in zip(outs, reqs))
    assert 0.0 < st.occupancy <= 1.0
    assert st.decode_steps >= max(len(o) - len(r) for o, r in zip(outs, reqs))
    assert st.slot_steps == st.decode_steps * 2 and st.live_slot_steps <= st.slot_steps
    assert st.scheduling_points >= 1 and st.wall_time_s > 0 and st.tokens_per_s > 0
    assert st.epoch_resets >= 1


def test_uniforms_are_counter_based():
    """The draw of (seed, r, g) is a function of those three alone, in [0, 1),
    and spread: different over seeds, requests and tokens."""
    req = torch.arange(64).repeat_interleave(64)
    g = torch.arange(64).repeat(64)
    u = cb_mod._uniforms(5, req, g)
    assert torch.equal(u, cb_mod._uniforms(5, req, g)) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert torch.equal(u[7 * 64 + 3:7 * 64 + 4], cb_mod._uniforms(5, torch.tensor([7]), torch.tensor([3])))
    assert not torch.equal(u, cb_mod._uniforms(6, req, g))
    assert len(torch.unique(u)) > 4000
    assert stats.kstest(u.double().numpy(), "uniform").pvalue > P_MIN


SAMPLE_KW = dict(topk=5, temperature=0.9, seed=3)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_sampling_schedule_invariant(pair, route):
    """A request's sample stream depends on (seed, r) alone: equal across
    pool sizes, check_every, admission orders (other requests' budgets move
    when request r is admitted) and both routes; per-request temperature /
    top-p lists equal single-request pools with that request's params."""
    _, om = pair
    reqs, budgets = REQS[:6], [9, 5, 12, 7, 4, 10]

    def run(pool, every, bud, **kw):
        cb = ContinuousBatchingGenerator(om, Tok(), batch_size=pool, prompt_bucket=16, check_every=every)
        return cb.generate_tokens_many(reqs, bud, **(SAMPLE_KW | kw))

    ref = run(3, 4, budgets)
    assert run(1, 1, budgets) == ref
    assert run(12, 3, budgets) == ref
    other = run(2, 2, [b if i in (0, 3) else b + 5 for i, b in enumerate(budgets)])
    assert other[0] == ref[0] and other[3] == ref[3]
    assert sum(len(set(o[len(q):])) for o, q in zip(ref, reqs)) >= 2 * len(reqs)
    temps, tps = [0.7, 1.3, 1.0, 0.9, 1.1, 0.8], [0.9, 0.5, 0.95, 1.0, 0.7, 0.8]
    mixed = run(2, 3, 10, top_p=tps, temperature=temps)
    for i in range(3):
        solo = ContinuousBatchingGenerator(om, Tok(), batch_size=1, prompt_bucket=16, check_every=1)
        assert solo.generate_tokens_many(reqs[:i + 1], 10, topk=5, top_p=tps[i], temperature=temps[i],
                                         seed=3)[i] == mixed[i]


def test_sampling_routes_agree(pair, monkeypatch):
    _, om = pair
    outs = {}
    for fused in (False, True):
        monkeypatch.setattr(attn, "USE_FUSED_STEP", fused)
        cb = ContinuousBatchingGenerator(om, Tok(), batch_size=12, prompt_bucket=16, check_every=4)
        outs[fused] = cb.generate_tokens_many(REQS[:16], BUDGETS[:16], top_p=0.9, temperature=1.1, seed=11)
    assert outs[False] == outs[True]


N_DRAWS = 1500
DIST_PROMPT = [3, 1, 4, 1, 5]


def _first_token_probs(om, topk, temperature) -> np.ndarray:
    """float64 top-k renormalised probabilities of the first token after
    DIST_PROMPT (the port's fp32 logits of the full forward)."""
    with torch.inference_mode():
        logits = dlm.decoder_lm_apply(om.params, om.cfg, torch.tensor(DIST_PROMPT))[-1].double().numpy()
    z = logits / temperature
    keep = np.argsort(-z, kind="stable")[:topk]
    p = np.zeros_like(z)
    p[keep] = np.exp(z[keep] - z[keep].max())
    return p / p.sum()


def _chi2(draws, p) -> float:
    counts = np.bincount(np.asarray(draws), minlength=len(p))
    assert counts[p == 0].sum() == 0
    keep = p > 0
    return stats.chisquare(counts[keep], p[keep] * len(draws)).pvalue


def test_sampling_distribution_matches_jax(pair):
    """The first sampled token of N_DRAWS requests of one prompt (top-k 5,
    temperature 0.9): the port's draws (pool of 32, fused twin) and the JAX
    engine's each pass a chi-square test against the float64 probabilities;
    and each other's counts."""
    jm, om = pair
    reqs = [DIST_PROMPT] * N_DRAWS
    attn.USE_FUSED_STEP = True
    try:
        ours = ContinuousBatchingGenerator(om, Tok(), batch_size=32, prompt_bucket=16,
                                           check_every=1).generate_tokens_many(reqs, 1, **SAMPLE_KW)
    finally:
        attn.USE_FUSED_STEP = None
    theirs = JaxCB(jm, Tok(), batch_size=32, prompt_bucket=16, check_every=1).generate_tokens_many(
        reqs, 1, **SAMPLE_KW)
    p = _first_token_probs(om, 5, 0.9)
    a, b = [o[-1] for o in ours], [o[-1] for o in theirs]
    assert _chi2(a, p) > P_MIN and _chi2(b, p) > P_MIN
    ca, cb = np.bincount(a, minlength=VOCAB), np.bincount(b, minlength=VOCAB)
    live = (ca + cb) > 0
    assert stats.chi2_contingency(np.stack([ca[live], cb[live]])).pvalue > P_MIN


@pytest.fixture()
def int8_pool(monkeypatch):
    """Both packages: the fused step forced on with int8 self-KV (the port's
    twin, JAX's kernel in interpret mode); jit caches cleared around it."""
    jax.clear_caches()
    for mod in (attn, jax_attn):
        monkeypatch.setattr(mod, "USE_FUSED_STEP", True)
        monkeypatch.setattr(mod, "USE_INT8_KV", True)
    yield
    jax.clear_caches()


@pytest.mark.parametrize("pool", [2, 16])
def test_int8_pool_matches_jax(int8_pool, pool):
    """The int8 pool (per-key int8 caches, admissions prefilled in full
    precision on a scratch and quantized at commit), with a prefix and a
    prompt longer than the bucket: token-identical to the JAX package's
    int8 pool (context 128: one int8 KV block)."""
    jm, om = _pair(seed=0, max_seq_len=128)
    prefix = [7, 8, 9]
    reqs = [[5, 6], [i * 3 % 512 for i in range(21)], [4], [3, 1, 4, 1, 5], [2, 7]]
    budgets = [6, 5, 8, 9, 4]
    rows = []
    real = ds.fused_decode_step

    def spy(*args, **kw):
        rows.append((args[2].dtype, args[2].shape[1], kw.get("kv_scales") is not None))
        return real(*args, **kw)

    ds.fused_decode_step = spy
    try:
        outs = ContinuousBatchingGenerator(om, Tok(), batch_size=pool, prompt_bucket=16,
                                           check_every=4).generate_tokens_many(reqs, budgets, shared_prefix=prefix)
    finally:
        ds.fused_decode_step = real
    with pltpu.force_tpu_interpret_mode():
        ref = JaxCB(jm, Tok(), batch_size=pool, prompt_bucket=16,
                    check_every=4).generate_tokens_many(reqs, budgets, shared_prefix=prefix)
    assert outs == ref
    assert rows and set(rows) == {(torch.int8, pool, True)}
