"""T5 continuous batching (``T5ContinuousBatchingGenerator``) of the PyTorch
port vs the JAX package's engine and the port's plain generator, on the CPU.

A small T5 (vocab 120, d 128, 2 heads of 64, 2 + 2 layers, mlp 256) loaded
in the JAX package from a synthetic flat t5x checkpoint made with
``numpy.random.default_rng`` (matrices at 0.05, rel-pos tables at 2.0, so
that the bias moves every output), bridged into the port by
``from_jax_params``. Two routes on the port's side: per-op (the CPU default:
the decode attention's plain version with the key-major bias and per-row
left pads) and fused (``USE_FUSED_STEP = True``: on CPU tensors the fused
step's wrapper runs its plain twin, with the pool-wide self bias row and
per-row pads; a spy counts its calls and their rows). fp32 throughout.
Tolerance: token identity, per request, with the JAX engine, with the
port's ``T5Generator.generate_tokens`` and across routes, pools of 1, 3 and
32 slots, mid-flight admissions over stale self and cross caches.

Sampling: the port draws generated token g of request r by the
counter-based uniform of (seed, r, g), JAX by ``fold_in`` keys; the streams
cannot match. Exactly: a request's stream does not depend on the pool size,
``check_every`` or the route. By distribution: the first sampled token of
many requests of one prompt, drawn by both engines, passes a chi-square
test against the top-k renormalised probabilities computed here in float64.

The int8 pools (``USE_INT8_KV`` and ``USE_INT8_KV_CROSS`` on the fused
route) are held token-identical to the JAX package's int8 pool, its kernel
in interpret mode, and to the port's plain generator under the same flags.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from scipy import stats

import pytorch_models_tpu.ops.attention as jax_attn
from pytorch_models_tpu.models.text import t5 as jax_t5
from pytorch_models_tpu.text import T5ContinuousBatchingGenerator as JaxT5CB
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.ops import decode_step as ds
from pytorch_models_tpu_torch.text import T5ContinuousBatchingGenerator, T5Generator, T5Model
from pytorch_models_tpu_torch.utils import from_jax_params

torch.set_num_threads(1)

DIMS = dict(vocab_size=120, dim=128, n_heads=2, n_layers=2, mlp_dim=256)
PAD = 0
MAX_TOKENS = 20
P_MIN = 1e-3  # chi-square p-value floor


def _t5x_flat(seed=61, s=0.05, bias_scale=2.0):
    """Synthetic flattened t5x checkpoint ({dotted key: (in, out) kernels})."""
    r = np.random.default_rng(seed)
    v, d, h, n, mlp = (DIMS[k] for k in ("vocab_size", "dim", "n_heads", "n_layers", "mlp_dim"))

    def rn(*shape, scale=s):
        return (r.standard_normal(shape) * scale).astype(np.float32)

    flat = {"token_embedder.embedding": rn(v, d, scale=1.0), "decoder.logits_dense.kernel": rn(d, v),
            "encoder.relpos_bias.rel_embedding": rn(h, 32, scale=bias_scale),
            "decoder.relpos_bias.rel_embedding": rn(h, 32, scale=bias_scale),
            "encoder.encoder_norm.scale": 1 + rn(d, scale=0.1), "decoder.decoder_norm.scale": 1 + rn(d, scale=0.1)}
    for side in ("encoder", "decoder"):
        for i in range(n):
            b = f"{side}.layers_{i}"
            kinds = [("self_attention", "pre_self_attention_layer_norm"),
                     ("encoder_decoder_attention", "pre_cross_attention_layer_norm")] if side == "decoder" else \
                [("attention", "pre_attention_layer_norm")]
            for kind, norm in kinds:
                flat[f"{b}.{norm}.scale"] = 1 + rn(d, scale=0.1)
                for proj, shape in (("query", (d, h * 64)), ("key", (d, h * 64)), ("value", (d, h * 64)),
                                    ("out", (h * 64, d))):
                    flat[f"{b}.{kind}.{proj}.kernel"] = rn(*shape)
            flat[f"{b}.pre_mlp_layer_norm.scale"] = 1 + rn(d, scale=0.1)
            flat |= {f"{b}.mlp.wi_0.kernel": rn(d, mlp), f"{b}.mlp.wi_1.kernel": rn(d, mlp),
                     f"{b}.mlp.wo.kernel": rn(mlp, d)}
    return flat


_R = np.random.default_rng(11)
PROMPTS = [_R.integers(2, 120, size=n).tolist() for n in (5, 37, 12, 70, 3, 21, 9)]


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model) over the same weights."""
    ref = jax_t5.T5Model(**DIMS)
    ref.load_t5x_state_dict(_t5x_flat())
    ours = T5Model(**DIMS, device="cpu")
    ours.params = from_jax_params(jax.tree.map(to_np, ref.params))
    return ref, ours


def _plain(om, prompts, eos, max_tokens=MAX_TOKENS):
    """The oracle: the port's generate_tokens per prompt on the per-op route,
    whatever route the test set."""
    gen = T5Generator(model=om)
    flag, attn.USE_FUSED_STEP = attn.USE_FUSED_STEP, False
    try:
        return [gen.generate_tokens(p, max_tokens, PAD, eos) for p in prompts]
    finally:
        attn.USE_FUSED_STEP = flag


@pytest.fixture(scope="module")
def refs(pair):
    """An EOS that the streams emit at spread steps (so that requests end at
    different times), the plain generator's outputs with it, and the JAX
    engine's at a pool of 2."""
    jm, om = pair
    free = [row[1:] for row in _plain(om, PROMPTS, -1)]

    def ends(t):  # where each stream would stop with EOS t (None: it emits t before its 3rd token)
        firsts = [row.index(t) if t in row else len(row) for row in free]
        return None if min(firsts) < 2 else firsts

    eos = max((t for row in free for t in row if ends(t)), key=lambda t: (len(set(ends(t))), t))
    plain = _plain(om, PROMPTS, eos)
    jax_out = JaxT5CB(jm, batch_size=2, check_every=4, pool_ctx=128).generate_tokens_many(
        PROMPTS, MAX_TOKENS, PAD, eos)
    assert jax_out == plain
    assert len({len(o) for o in plain}) >= 3 and sum(len(set(o[1:])) for o in plain) >= 3 * len(PROMPTS)
    return eos, plain


ROUTES = ("per-op", "fused")


@pytest.fixture()
def route(request, monkeypatch):
    """``fused`` forces USE_FUSED_STEP (the twin on CPU tensors); returns
    (rows, pad_lens given) of every fused cross step called."""
    calls = []
    monkeypatch.setattr(attn, "USE_FUSED_STEP", request.param == "fused")
    real = ds.fused_cross_decode_step

    def spy(*args, **kw):
        calls.append((args[2].shape[1], args[8] is not None, kw.get("sbias") is not None))
        return real(*args, **kw)

    monkeypatch.setattr(ds, "fused_cross_decode_step", spy)
    return request.param, calls


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("pool", [1, 3, 32])
def test_greedy_pool_matches_jax_and_plain(pair, refs, route, pool):
    """Seven prompts of 3-70 tokens, EOS at spread steps: mid-flight
    admissions into slots holding a previous request's self and cross K/V,
    one pool-wide bias table for every shifted row; every request
    token-identical to the JAX engine's (which equals the plain
    generator's) and to the port's plain generator. On the fused route every
    step is one call of the fused step over the whole pool, with pads and
    the self bias."""
    name, calls = route
    _, om = pair
    eos, plain = refs
    cb = T5ContinuousBatchingGenerator(om, batch_size=pool, check_every=4, pool_ctx=128)
    assert cb.generate_tokens_many(PROMPTS, MAX_TOKENS, PAD, eos) == plain
    st = cb.last_stats
    assert st.admissions == len(PROMPTS)
    if name == "fused":
        assert len(calls) == st.decode_steps and set(calls) == {(pool, True, True)}
    else:
        assert calls == []


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_epoch_reset(pair, refs, route):
    """A pool context so small that the position budget runs out mid-queue:
    the pool drains, rewinds and readmits, still exact."""
    _, om = pair
    eos, _ = refs
    cb = T5ContinuousBatchingGenerator(om, batch_size=2, check_every=8, pool_ctx=40)
    assert cb.generate_tokens_many(PROMPTS[:5], 18, PAD, eos) == _plain(om, PROMPTS[:5], eos, 18)
    assert cb.last_stats.epoch_resets >= 1


def test_empty_queue_limits_and_text_api(pair, refs):
    jm, om = pair
    eos, plain = refs
    cb = T5ContinuousBatchingGenerator(om, batch_size=2)
    assert cb.generate_tokens_many([], 16, PAD, eos) == []
    assert cb.pool_ctx is None  # default: 4 x max_tokens per call
    with pytest.raises(ValueError, match="pad token"):
        cb.generate_tokens_many(PROMPTS[:1], 1, PAD, eos)
    with pytest.raises(ValueError, match="pool context"):
        T5ContinuousBatchingGenerator(om, pool_ctx=8).generate_tokens_many(PROMPTS[:1], 16, PAD, eos)
    with pytest.raises(ValueError, match="empty prompt"):
        cb.generate_tokens_many([[]], 16, PAD, eos)
    with pytest.raises(ValueError, match="tokenizer"):
        cb.generate_many(["a"])

    class Tok:  # sentencepiece's surface
        def Encode(self, text, add_eos=False):
            return [2 + ord(c) % 100 for c in text] + ([eos] if add_eos else [])

        def Decode(self, ids):
            return " ".join(map(str, ids))

        def pad_id(self):
            return PAD

        def eos_id(self):
            return eos

    cb.tokenizer = Tok()
    texts = ["translate this", "ab"]
    ids = [Tok().Encode(t, add_eos=True) for t in texts]
    assert cb.generate_many(texts, MAX_TOKENS) == [Tok().Decode(o) for o in _plain(om, ids, eos)]


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_streaming_callback_delivers_every_token_once(pair, refs, route):
    """on_tokens: each generated token once, in order, at scheduling-point
    granularity (the output minus its pad token); with sampling too."""
    _, om = pair
    eos, plain = refs
    streams, calls = {i: [] for i in range(len(PROMPTS))}, []
    cb = T5ContinuousBatchingGenerator(om, batch_size=2, check_every=4, pool_ctx=128)
    outs = cb.generate_tokens_many(PROMPTS, MAX_TOKENS, PAD, eos,
                                   on_tokens=lambda r, ts: (streams[r].extend(ts), calls.append(len(ts))))
    assert outs == plain
    assert all(streams[i] == o[1:] for i, o in enumerate(outs))
    assert all(1 <= n <= 4 for n in calls)
    streams = {i: [] for i in range(3)}
    outs = cb.generate_tokens_many(PROMPTS[:3], 12, PAD, eos, topk=4, seed=9,
                                   on_tokens=lambda r, ts: streams[r].extend(ts))
    assert all(streams[i] == o[1:] for i, o in enumerate(outs))


def test_serving_stats(pair, refs):
    _, om = pair
    eos, _ = refs
    cb = T5ContinuousBatchingGenerator(om, batch_size=2, check_every=4, pool_ctx=40)
    outs = cb.generate_tokens_many(PROMPTS[:5], 18, PAD, eos)
    st = cb.last_stats
    assert st.requests == st.admissions == 5
    assert st.tokens_generated == sum(len(o) - 1 for o in outs)
    assert 0.0 < st.occupancy <= 1.0 and st.slot_steps == 2 * st.decode_steps
    assert st.live_slot_steps <= st.slot_steps and st.decode_steps >= max(len(o) for o in outs) - 1
    assert st.scheduling_points >= 1 and st.epoch_resets >= 1 and st.wall_time_s > 0 and st.tokens_per_s > 0


def test_batched_admission_encodes(pair, refs, monkeypatch):
    """Four free slots admit four requests at one scheduling point through
    ONE encoder call of the pool's shared bucket (128 here: the 70-token
    prompt's; each plain run encodes in its own, 64 or 128); outputs equal
    the plain generator's."""
    _, om = pair
    eos, plain = refs
    from pytorch_models_tpu_torch.models.text import t5_continuous

    shapes = []
    real = t5_continuous.t5_encode

    def spy(params, cfg, tokens, pad_bias=None):
        shapes.append(tuple(tokens.shape))
        return real(params, cfg, tokens, pad_bias)

    monkeypatch.setattr(t5_continuous, "t5_encode", spy)
    cb = T5ContinuousBatchingGenerator(om, batch_size=4, check_every=4, pool_ctx=128)
    assert cb.generate_tokens_many(PROMPTS, MAX_TOKENS, PAD, eos) == plain
    assert shapes[0] == (4, 128) and all(s[1] == 128 and s[0] in (1, 2, 4) for s in shapes)
    assert len(shapes) < len(PROMPTS)


SAMPLE_KW = dict(topk=5, temperature=0.9, seed=3)


def test_sampling_schedule_invariant(pair, refs, monkeypatch):
    """A request's sample stream depends on (seed, r) alone: equal across
    pools of 1 and 3, check_every 1 and 16, and the two routes."""
    _, om = pair
    eos, _ = refs

    def run(pool, every, fused):
        monkeypatch.setattr(attn, "USE_FUSED_STEP", fused)
        cb = T5ContinuousBatchingGenerator(om, batch_size=pool, check_every=every, pool_ctx=128)
        return cb.generate_tokens_many(PROMPTS[:4], 14, PAD, eos, **SAMPLE_KW)

    ref = run(3, 16, False)
    assert run(1, 1, False) == ref
    assert run(3, 1, True) == ref
    assert run(1, 16, True) == ref
    assert sum(len(set(o[1:])) for o in ref) >= 3 * 4


def test_per_request_sampling_params(pair, refs):
    """Per-request temperature / top-p lists: each request's stream equals a
    one-slot pool's with that request's scalar parameters at the same
    index."""
    _, om = pair
    eos, _ = refs
    temps, tps = [0.7, 1.2, 1.0], [0.9, 0.6, 0.95]
    cb = T5ContinuousBatchingGenerator(om, batch_size=2, check_every=3, pool_ctx=128)
    mixed = cb.generate_tokens_many(PROMPTS[:3], 12, PAD, eos, topk=6, top_p=tps, temperature=temps, seed=5)
    for r in range(3):
        solo = T5ContinuousBatchingGenerator(om, batch_size=1, check_every=1, pool_ctx=128)
        assert solo.generate_tokens_many(PROMPTS[:r + 1], 12, PAD, eos, topk=6, top_p=tps[r],
                                         temperature=temps[r], seed=5)[r] == mixed[r]


N_DRAWS = 1500


def test_sampling_distribution_matches_jax(pair):
    """The first sampled token of N_DRAWS requests of one prompt (top-k 5,
    temperature 0.9): the port's draws (pool of 32, fused twin) and the JAX
    engine's each pass a chi-square test against the float64 top-k
    probabilities of the port's logits, and against each other's counts."""
    jm, om = pair
    prompts = [PROMPTS[2]] * N_DRAWS
    attn.USE_FUSED_STEP = True
    try:
        ours = T5ContinuousBatchingGenerator(om, batch_size=32, check_every=1).generate_tokens_many(
            prompts, 2, PAD, -1, **SAMPLE_KW)
    finally:
        attn.USE_FUSED_STEP = None
    theirs = JaxT5CB(jm, batch_size=32, check_every=1).generate_tokens_many(prompts, 2, PAD, -1, **SAMPLE_KW)
    with torch.inference_mode():
        logits = om(torch.tensor([PROMPTS[2]]), torch.tensor([[PAD]]))[0, -1].double().numpy()
    z = logits / SAMPLE_KW["temperature"]
    keep = np.argsort(-z, kind="stable")[:SAMPLE_KW["topk"]]
    p = np.zeros_like(z)
    p[keep] = np.exp(z[keep] - z[keep].max())
    p /= p.sum()
    for draws in ([o[-1] for o in ours], [o[-1] for o in theirs]):
        counts = np.bincount(draws, minlength=len(p))
        assert counts[p == 0].sum() == 0
        assert stats.chisquare(counts[p > 0], p[p > 0] * N_DRAWS).pvalue > P_MIN
    ca, cb = (np.bincount([o[-1] for o in x], minlength=len(p)) for x in (ours, theirs))
    live = (ca + cb) > 0
    assert stats.chi2_contingency(np.stack([ca[live], cb[live]])).pvalue > P_MIN


def _int8(monkeypatch, kv: bool, kv_cross: bool):
    jax.clear_caches()
    for mod in (attn, jax_attn):
        monkeypatch.setattr(mod, "USE_FUSED_STEP", True)
        monkeypatch.setattr(mod, "USE_INT8_KV", kv)
        monkeypatch.setattr(mod, "USE_INT8_KV_CROSS", kv_cross)


def test_int8_pool_matches_jax(pair, monkeypatch):
    """The int8 pool (self caches per key in int8 from the first step, the
    rel-pos bias and per-row pads on the int8 attention; each prompt's cross
    K/V quantized once at admission), mid-flight admissions over stale
    quantized state: token-identical to the JAX package's int8 pool and to
    the port's plain generator under the same flags."""
    jm, om = pair
    _int8(monkeypatch, True, True)
    calls = []
    real = ds.fused_cross_decode_step

    def spy(*args, **kw):
        calls.append((args[2].dtype, args[4].dtype, args[2].shape[1], args[8] is not None))
        return real(*args, **kw)

    monkeypatch.setattr(ds, "fused_cross_decode_step", spy)
    outs = T5ContinuousBatchingGenerator(om, batch_size=2, check_every=4, pool_ctx=64).generate_tokens_many(
        PROMPTS[:5], 14, PAD, -1)
    assert calls and set(calls) == {(torch.int8, torch.int8, 2, True)}
    try:
        with pltpu.force_tpu_interpret_mode():
            ref = JaxT5CB(jm, batch_size=2, check_every=4, pool_ctx=64).generate_tokens_many(
                PROMPTS[:5], 14, PAD, -1)
    finally:
        jax.clear_caches()
    assert outs == ref
    assert outs == [T5Generator(model=om).generate_tokens(p, 14, PAD, -1) for p in PROMPTS[:5]]


@pytest.mark.parametrize("kv", [False, True], ids=["cross_only", "self_only"])
def test_int8_single_stream_pools_match_plain(pair, monkeypatch, kv):
    """int8 cross only (full-precision self pool) and int8 self only (a pool
    of 16: two row groups, 8 x 2 heads within the 128 (row, head) rule):
    each stream's gate on its own, token-identical to the plain generator
    under the same flags."""
    _, om = pair
    _int8(monkeypatch, kv, not kv)
    outs = T5ContinuousBatchingGenerator(om, batch_size=16 if kv else 3, check_every=5, pool_ctx=64) \
        .generate_tokens_many(PROMPTS, 12, PAD, -1)
    assert outs == [T5Generator(model=om).generate_tokens(p, 12, PAD, -1) for p in PROMPTS]
