"""The fused decode step (K7) of the PyTorch port vs the JAX package, on the CPU.

The port's wrappers run the kernel's plain version on CPU tensors; the JAX
side runs its Pallas kernel in interpret mode, as tests/ops/test_decode_step.py
does. Sizes the JAX kernel's gate admits: 2 layers, d_model 128, 2 heads of
64 (H*D 128), dff 512, caches a multiple of 32 long. Parameters come from
the JAX package's init (converted with ``from_jax_params``); inputs are made
with ``numpy.random.default_rng`` and handed to both sides.

fp32 throughout: the two sides sum in other orders, so ``x_out`` is held to
2e-4 (the JAX tests' own bound of its kernel against its layer stack), the
K/V written at ``pos`` (one projection) to 2e-5, and greedy tokens exactly.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import pytorch_models_tpu.models.audio2text as jax_a2t
import pytorch_models_tpu.models.text as jax_text
import pytorch_models_tpu.ops.attention as jax_attn
import pytorch_models_tpu.ops.decode_step as jax_ds
import pytorch_models_tpu.transformer as jax_tfm
from pytorch_models_tpu.models.text import t5 as jax_t5
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch import transformer as tfm
from pytorch_models_tpu_torch.audio2text import Whisper, WhisperGenerator
from pytorch_models_tpu_torch.models.text import GPT2, DecoderGenerator
from pytorch_models_tpu_torch.models.text import _decoder_lm as dlm
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.ops import decode_step as ds
from pytorch_models_tpu_torch.utils import from_jax_params

torch.set_num_threads(1)

B, D, N_LAYERS = 4, 128, 2
X_TOL = 2e-4
KV_TOL = 2e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _layers(cross: bool, seed: int = 0):
    cfg = jax_tfm.LayerConfig.make(D, n_heads=2, cross_attn=cross,
                                   act="gelu" if cross else "approximate_gelu")
    jp = jax_tfm.decoder_init(jax.random.PRNGKey(seed), N_LAYERS, cfg)
    ours = from_jax_params(jax.tree.map(to_np, jp))["layers"]
    return cfg, jp, ours


def _caches(r, l_max):
    hd = D  # 2 heads x 64
    k = r.standard_normal((N_LAYERS, B, l_max, hd)).astype(np.float32)
    v = r.standard_normal((N_LAYERS, B, l_max, hd)).astype(np.float32)
    return k, v


@pytest.fixture()
def fused_on(monkeypatch):
    """Both packages' USE_FUSED_STEP forced on (the port's wrappers then run
    the plain version on CPU tensors); jit caches cleared around the change,
    since the JAX flag is read at trace time."""
    jax.clear_caches()
    monkeypatch.setattr(attn, "USE_FUSED_STEP", True)
    monkeypatch.setattr(jax_attn, "USE_FUSED_STEP", True)
    yield
    jax.clear_caches()


@pytest.mark.parametrize("cross", [False, True])
def test_pack_decode_weights_matches_jax(cross):
    _, jp, ours = _layers(cross)
    expected = jax_ds.pack_decode_weights(jp["layers"], jnp.float32, cross=cross)
    got = ds.pack_decode_weights(ours, torch.float32, cross=cross)
    assert set(got) == set(expected)
    for k, v in expected.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def _t5_layers(seed: int = 2):
    """A T5 decoder stack (RMSNorm, GEGLU, cross-attention) from the JAX init,
    with its rel-pos table seeded at scale 2 (the init's is zeros, which would
    hide a dropped bias) and its norms perturbed off their unit init."""
    cfg = jax_t5.T5Config(vocab_size=300, dim=D, n_heads=2, n_layers=N_LAYERS, mlp_dim=256)
    dec = jax_t5.t5_stack_init(jax.random.PRNGKey(seed), cfg, cross_attn=True)
    r = np.random.default_rng(seed)
    dec["attn_bias"] = jnp.asarray(2.0 * r.standard_normal((2, 32)), jnp.float32)
    for name in ("sa_norm", "ca_norm", "mlp_norm"):
        dec["layers"][name]["scale"] = jnp.asarray(1 + 0.1 * r.standard_normal((N_LAYERS, D)), jnp.float32)
    return cfg, dec, from_jax_params(jax.tree.map(to_np, dec))["layers"]


def test_pack_decode_weights_gated_matches_jax():
    _, dec, ours = _t5_layers()
    expected = jax_ds.pack_decode_weights(dec["layers"], jnp.float32, gated=True, cross=True, norm="rms")
    got = ds.pack_decode_weights(ours, torch.float32, cross=True, gated=True)
    assert set(got) == set(expected) and got["w1"].shape == (N_LAYERS, D, 512)
    for k, v in expected.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_pack_greedy_head_matches_jax():
    r = np.random.default_rng(5)
    emb = r.standard_normal((300, D)).astype(np.float32)
    norm = {"scale": (1 + 0.1 * r.standard_normal(D)).astype(np.float32)}  # no bias: zeros on both sides
    head, v = jax_ds.pack_greedy_head(jnp.asarray(emb), {"scale": jnp.asarray(norm["scale"])}, jnp.float32)
    got = ds.pack_greedy_head(_t(emb), {"scale": _t(norm["scale"])}, torch.float32)
    assert v == got["emb"].shape[0] == 300  # the port does not pad the vocabulary
    np.testing.assert_array_equal(got["emb"].numpy(), np.asarray(head["emb"])[:300])
    np.testing.assert_array_equal(got["fn_s"].numpy(), np.asarray(head["fn_s"])[0])
    np.testing.assert_array_equal(got["fn_b"].numpy(), np.asarray(head["fn_b"])[0])
    bf = ds.pack_greedy_head(got["emb"].bfloat16(), {"scale": _t(norm["scale"])}, torch.bfloat16)
    assert bf["emb"].dtype == torch.bfloat16


# (l_max, pos, pads): an empty cache; mixed pads with one row whose cached
# range is empty until pos; an eight-block deep ring as in the JAX tests
@pytest.mark.parametrize("l_max,pos,pads", [(128, 0, None), (128, 37, (0, 1, 5, 37)), (1024, 960, (0, 3, 900, 17))])
def test_fused_step_matches_jax(l_max, pos, pads):
    r = np.random.default_rng(191)
    cfg, jp, ours = _layers(cross=False)
    x = r.standard_normal((B, D)).astype(np.float32)
    k, v = _caches(r, l_max)
    if pos == 0:
        k[:], v[:] = 0.0, 0.0
    pads_np = None if pads is None else np.asarray(pads, np.int32)
    with pltpu.force_tpu_interpret_mode():
        x_ref, k_new, v_new = jax_ds.fused_decode_step(
            jnp.asarray(x), jax_ds.pack_decode_weights(jp["layers"], jnp.float32), jnp.asarray(k), jnp.asarray(v),
            pos, None if pads is None else jnp.asarray(pads_np), n_heads=cfg.n_heads, act=cfg.act, eps=cfg.norm_eps)

    kc, vc = _t(k), _t(v)
    x_out, tok = ds.fused_decode_step(_t(x), ds.pack_decode_weights(ours, torch.float32), kc, vc, pos,
                                      None if pads is None else _t(pads_np), cfg.n_heads, cfg.act, cfg.norm_eps)
    assert tok is None
    np.testing.assert_allclose(x_out.numpy(), np.asarray(x_ref), rtol=X_TOL, atol=X_TOL)
    # the in-place cache write at pos holds what the JAX function returns
    np.testing.assert_allclose(kc[:, :, pos].numpy(), np.asarray(k_new), rtol=KV_TOL, atol=KV_TOL)
    np.testing.assert_allclose(vc[:, :, pos].numpy(), np.asarray(v_new), rtol=KV_TOL, atol=KV_TOL)
    others = np.arange(l_max) != pos
    np.testing.assert_array_equal(kc.numpy()[:, :, others], k[:, :, others])


@pytest.mark.parametrize("vocab", [300, 4099])
def test_fused_step_head_matches_jax(vocab):
    """The head phase: final norm + greedy argmax in the same step."""
    r = np.random.default_rng(196)
    cfg, jp, ours = _layers(cross=False)
    pos, l_max = 17, 128
    x = r.standard_normal((B, D)).astype(np.float32)
    k, v = _caches(r, l_max)
    emb = r.standard_normal((vocab, D)).astype(np.float32)
    fs, fb = (1 + 0.1 * r.standard_normal(D)).astype(np.float32), (0.1 * r.standard_normal(D)).astype(np.float32)
    head, head_v = jax_ds.pack_greedy_head(jnp.asarray(emb), {"scale": jnp.asarray(fs), "bias": jnp.asarray(fb)},
                                           jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        x_ref, _, _, tok_ref = jax_ds.fused_decode_step(
            jnp.asarray(x), jax_ds.pack_decode_weights(jp["layers"], jnp.float32), jnp.asarray(k), jnp.asarray(v),
            pos, None, n_heads=cfg.n_heads, act=cfg.act, eps=cfg.norm_eps, head=head, head_v=head_v)
    x_out, tok = ds.fused_decode_step(_t(x), ds.pack_decode_weights(ours, torch.float32), _t(k), _t(v), pos, None,
                                      cfg.n_heads, cfg.act, cfg.norm_eps,
                                      head=ds.pack_greedy_head(_t(emb), {"scale": _t(fs), "bias": _t(fb)},
                                                               torch.float32))
    np.testing.assert_allclose(x_out.numpy(), np.asarray(x_ref), rtol=X_TOL, atol=X_TOL)
    assert tok.dtype == torch.int64 and tok.tolist() == np.asarray(tok_ref).tolist()


@pytest.mark.parametrize("l_max,pos,l_mem,valid_lens,with_head",
                         [(128, 21, 40, (40, 17, 3, 40), True), (1024, 960, 1024, (1000, 17, 3, 640), False)])
def test_fused_cross_step_matches_jax(l_max, pos, l_mem, valid_lens, with_head):
    """Whisper-style: self-attention + cross-attention over per-row valid
    lengths (one short row) + MLP [+ head]."""
    r = np.random.default_rng(193)
    cfg, jp, ours = _layers(cross=True, seed=1)
    x = r.standard_normal((B, D)).astype(np.float32)
    k, v = _caches(r, l_max)
    memory = r.standard_normal((B, l_mem, D)).astype(np.float32)
    valid = np.asarray(valid_lens, np.int32)
    cross = jax_tfm.precompute_cross_caches(jp, cfg, jnp.asarray(memory), valid_lens=jnp.asarray(valid))
    pads = np.asarray([0, 2, 0, 1], np.int32)
    emb = r.standard_normal((300, D)).astype(np.float32)
    fs = (1 + 0.1 * r.standard_normal(D)).astype(np.float32)
    kw = {}
    if with_head:
        head, head_v = jax_ds.pack_greedy_head(jnp.asarray(emb), {"scale": jnp.asarray(fs)}, jnp.float32)
        kw = {"head": head, "head_v": head_v}
    with pltpu.force_tpu_interpret_mode():
        out = jax_ds.fused_cross_decode_step(
            jnp.asarray(x), jax_ds.pack_decode_weights(jp["layers"], jnp.float32, cross=True), jnp.asarray(k),
            jnp.asarray(v), cross["k"], cross["v"], cross["len"][0], pos, jnp.asarray(pads), n_heads=cfg.n_heads,
            act=cfg.act, eps=cfg.norm_eps, norm="ln", **kw)

    kc, vc = _t(k), _t(v)
    x_out, tok = ds.fused_cross_decode_step(
        _t(x), ds.pack_decode_weights(ours, torch.float32, cross=True), kc, vc, _t(cross["k"]), _t(cross["v"]),
        _t(valid), pos, _t(pads), cfg.n_heads, cfg.act, cfg.norm_eps,
        head=ds.pack_greedy_head(_t(emb), {"scale": _t(fs)}, torch.float32) if with_head else None)
    np.testing.assert_allclose(x_out.numpy(), np.asarray(out[0]), rtol=X_TOL, atol=X_TOL)
    np.testing.assert_allclose(kc[:, :, pos].numpy(), np.asarray(out[1]), rtol=KV_TOL, atol=KV_TOL)
    np.testing.assert_allclose(vc[:, :, pos].numpy(), np.asarray(out[2]), rtol=KV_TOL, atol=KV_TOL)
    if with_head:
        assert tok.tolist() == np.asarray(out[3]).tolist()


# (pos, pads): T5's first step (pos 0, zero caches: only the current key), a
# later step; and a later step with left pads (the kernel serves them for T5 too)
@pytest.mark.parametrize("pos,pads", [(0, None), (13, None), (37, (0, 2, 37, 1))])
def test_fused_t5_step_matches_jax(pos, pads):
    """K7-T5: RMSNorm, GEGLU, the key-major rel-pos self bias, cross-attention
    over per-row lengths and the untied head, vs the JAX kernel in interpret
    mode (tests/ops/test_decode_step.py's T5 case, with the head added)."""
    r = np.random.default_rng(194)
    cfg, dec, ours = _t5_layers()
    lc = cfg.layer
    l_max, l_mem = 128, 24
    x = r.standard_normal((B, D)).astype(np.float32)
    k, v = _caches(r, l_max)
    if pos == 0:
        k[:], v[:] = 0.0, 0.0
    memory = r.standard_normal((B, l_mem, D)).astype(np.float32)
    valid = np.asarray([24, 9, 24, 3], np.int32)
    cross = jax_tfm.precompute_cross_caches(dec, lc, jnp.asarray(memory), valid_lens=jnp.asarray(valid))
    table = jax_t5.relative_position_bias(dec["attn_bias"], jnp.arange(48), jnp.arange(l_max), False, cfg)
    sbias = np.ascontiguousarray(np.asarray(table)[:, pos, :].T)  # (Lp, H) key-major
    w = (0.3 * r.standard_normal((D, 300))).astype(np.float32)  # untied (d, V) classifier
    fs = (1 + 0.1 * r.standard_normal(D)).astype(np.float32)
    head, head_v = jax_ds.pack_greedy_head(jnp.asarray(w), {"scale": jnp.asarray(fs)}, jnp.float32, tied=False)
    pads_np = None if pads is None else np.asarray(pads, np.int32)
    with pltpu.force_tpu_interpret_mode():
        out = jax_ds.fused_cross_decode_step(
            jnp.asarray(x), jax_ds.pack_decode_weights(dec["layers"], jnp.float32, gated=True, cross=True, norm="rms"),
            jnp.asarray(k), jnp.asarray(v), cross["k"], cross["v"], cross["len"][0], pos,
            None if pads is None else jnp.asarray(pads_np), n_heads=2, act="approximate_gelu", eps=1e-5, norm="rms",
            gated=True, sbias=jnp.pad(jnp.asarray(sbias), ((0, 0), (0, 126))), head=head, head_v=head_v)

    packed = ds.pack_decode_weights(ours, torch.float32, cross=True, gated=True)
    ours_head = ds.pack_greedy_head(_t(w), {"scale": _t(fs)}, torch.float32, tied=False)

    def step(sb):
        kc, vc = _t(k), _t(v)
        x_out, tok = ds.fused_cross_decode_step(
            _t(x), packed, kc, vc, _t(cross["k"]), _t(cross["v"]), _t(valid), pos,
            None if pads is None else _t(pads_np), 2, "approximate_gelu", 1e-5, head=ours_head, norm="rms",
            gated=True, sbias=sb)
        return x_out, tok, kc, vc

    x_out, tok, kc, vc = step(_t(sbias))
    np.testing.assert_allclose(x_out.numpy(), np.asarray(out[0]), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(kc[:, :, pos].numpy(), np.asarray(out[1]), rtol=KV_TOL, atol=KV_TOL)
    np.testing.assert_allclose(vc[:, :, pos].numpy(), np.asarray(out[2]), rtol=KV_TOL, atol=KV_TOL)
    assert tok.tolist() == np.asarray(out[3]).tolist()
    if pos > 0:  # the bias matters (at pos 0 it shifts the one score of each head and cancels)
        assert np.abs(step(None)[0].numpy() - np.asarray(out[0])).max() > 100 * 3e-4


# above one row group (the kernel serves up to ops.decode_step.MAX_BATCH = 32 rows in groups of 8): the twin
# against the JAX kernel at B = 12 and 32, base (with its head), cross (Whisper-style, head) and T5 (RMSNorm,
# GEGLU, the rel-pos self bias, the untied head); per-row pads, cross lengths cycled over the rows
@pytest.mark.parametrize("b", [12, 32])
@pytest.mark.parametrize("kind", ["base", "cross", "t5"])
def test_fused_step_above_one_row_group_matches_jax(kind, b):
    r = np.random.default_rng(197)
    pos, l_max, l_mem = 37, 128, 24
    x = r.standard_normal((b, D)).astype(np.float32)
    k = r.standard_normal((N_LAYERS, b, l_max, D)).astype(np.float32)
    v = r.standard_normal((N_LAYERS, b, l_max, D)).astype(np.float32)
    pads = np.asarray([(0, 2, 37, 1, 5, 0)[i % 6] for i in range(b)], np.int32)
    valid = np.asarray([(24, 9, 24, 3)[i % 4] for i in range(b)], np.int32)
    fs = (1 + 0.1 * r.standard_normal(D)).astype(np.float32)
    jkw, kw = {}, {}
    if kind == "t5":
        cfg, dec, ours = _t5_layers()
        lc, jlayers, jp = cfg.layer, dec["layers"], dec
        table = jax_t5.relative_position_bias(dec["attn_bias"], jnp.arange(48), jnp.arange(l_max), False, cfg)
        sbias = np.ascontiguousarray(np.asarray(table)[:, pos, :].T)
        w = (0.3 * r.standard_normal((D, 300))).astype(np.float32)
        head, head_v = jax_ds.pack_greedy_head(jnp.asarray(w), {"scale": jnp.asarray(fs)}, jnp.float32, tied=False)
        ours_head = ds.pack_greedy_head(_t(w), {"scale": _t(fs)}, torch.float32, tied=False)
        jkw = dict(norm="rms", gated=True, sbias=jnp.pad(jnp.asarray(sbias), ((0, 0), (0, 126))))
        kw = dict(norm="rms", gated=True, sbias=_t(sbias))
        n_heads, act, eps = 2, "approximate_gelu", 1e-5
    else:
        lc, jp, ours = _layers(cross=kind == "cross", seed=1)
        jlayers = jp["layers"]
        emb = r.standard_normal((300, D)).astype(np.float32)
        head, head_v = jax_ds.pack_greedy_head(jnp.asarray(emb), {"scale": jnp.asarray(fs)}, jnp.float32)
        ours_head = ds.pack_greedy_head(_t(emb), {"scale": _t(fs)}, torch.float32)
        n_heads, act, eps = lc.n_heads, lc.act, lc.norm_eps
        if kind == "cross":
            jkw = dict(norm="ln")
    gated = kind == "t5"
    packed_j = jax_ds.pack_decode_weights(jlayers, jnp.float32, cross=kind != "base", gated=gated,
                                          **({"norm": "rms"} if gated else {}))
    packed = ds.pack_decode_weights(ours, torch.float32, cross=kind != "base", gated=gated)
    kc, vc = _t(k), _t(v)
    with pltpu.force_tpu_interpret_mode():
        if kind == "base":
            out = jax_ds.fused_decode_step(jnp.asarray(x), packed_j, jnp.asarray(k), jnp.asarray(v), pos,
                                           jnp.asarray(pads), n_heads=n_heads, act=act, eps=eps, head=head,
                                           head_v=head_v)
        else:
            memory = r.standard_normal((b, l_mem, D)).astype(np.float32)
            cross = jax_tfm.precompute_cross_caches(jp, lc, jnp.asarray(memory), valid_lens=jnp.asarray(valid))
            out = jax_ds.fused_cross_decode_step(
                jnp.asarray(x), packed_j, jnp.asarray(k), jnp.asarray(v), cross["k"], cross["v"], cross["len"][0],
                pos, jnp.asarray(pads), n_heads=n_heads, act=act, eps=eps, head=head, head_v=head_v, **jkw)
    if kind == "base":
        x_out, tok = ds.fused_decode_step(_t(x), packed, kc, vc, pos, _t(pads), n_heads, act, eps, head=ours_head)
    else:
        x_out, tok = ds.fused_cross_decode_step(_t(x), packed, kc, vc, _t(cross["k"]), _t(cross["v"]), _t(valid),
                                                pos, _t(pads), n_heads, act, eps, head=ours_head, **kw)
    np.testing.assert_allclose(x_out.numpy(), np.asarray(out[0]), rtol=3e-4 if gated else X_TOL,
                               atol=3e-4 if gated else X_TOL)
    np.testing.assert_allclose(kc[:, :, pos].numpy(), np.asarray(out[1]), rtol=KV_TOL, atol=KV_TOL)
    np.testing.assert_allclose(vc[:, :, pos].numpy(), np.asarray(out[2]), rtol=KV_TOL, atol=KV_TOL)
    assert tok.shape == (b,) and tok.tolist() == np.asarray(out[3]).tolist()


def test_stacked_caches_are_views_of_one_buffer():
    """The per-op prefill written through the per-layer views of the stacked
    caches equals one written into separate per-layer tensors, and the
    stacked cross projection equals the per-layer one."""
    r = np.random.default_rng(7)
    _, _, layers = _layers(cross=True)
    lc = tfm.LayerConfig.make(D, n_heads=2, cross_attn=True)
    p = {"layers": layers}
    x = _t(r.standard_normal((B, 9, D)).astype(np.float32))
    memory = _t(r.standard_normal((B, 40, D)).astype(np.float32))
    pads = torch.tensor([0, 2, 4, 1], dtype=torch.int32)

    flat = [{k: torch.zeros(B, 128, D) for k in ("k", "v")} for _ in range(N_LAYERS)]
    views, stacked = tfm.make_kv_cache(N_LAYERS, (B,), 2, 64, 64)
    assert stacked["k"].shape == (N_LAYERS, B, 128, D)
    cross_list = [tfm.mha_project_kv(lp["ca"], lc, memory) for lp in layers]
    cross_views, cross_stacked = tfm.precompute_cross_caches(p, lc, memory)
    for i, (got, ref) in enumerate(zip(cross_views, cross_list)):
        for k in ("k", "v"):
            torch.testing.assert_close(got[k], ref[k], rtol=0, atol=1e-6)
            assert got[k].data_ptr() == cross_stacked[k][i].data_ptr()
    assert torch.equal(cross_stacked["len"], cross_list[0]["len"])

    ref_out, _ = tfm.decoder_apply(p, lc, x, self_caches=flat, cross_caches=cross_list, pos=0, pad_lens=pads)
    got_out, _ = tfm.decoder_apply(p, lc, x, self_caches=views, cross_caches=cross_views, pos=0, pad_lens=pads)
    torch.testing.assert_close(got_out, ref_out, rtol=0, atol=1e-5)
    for i in range(N_LAYERS):
        for k in ("k", "v"):
            torch.testing.assert_close(stacked[k][i], flat[i][k], rtol=0, atol=1e-6)
            assert views[i][k].data_ptr() == stacked[k][i].data_ptr()


def test_fused_step_eligible_states_the_kernels_shapes():
    _, _, layers = _layers(cross=True)
    lc = tfm.LayerConfig.make(D, n_heads=2, cross_attn=True)
    assert ds.fused_step_eligible(layers, lc, 8, cross=True) and ds.fused_step_eligible(layers, lc, 32, cross=True)
    assert not ds.fused_step_eligible(layers, lc, 33, cross=True)  # more rows than the kernel serves
    assert not ds.fused_step_eligible(layers, tfm.LayerConfig.make(D, n_heads=4), 4)  # head_dim 32
    assert not ds.fused_step_eligible(layers, tfm.LayerConfig.make(D, n_heads=2, pre_norm=False), 4)
    assert ds.fused_step_eligible(layers, tfm.LayerConfig.make(D, n_heads=2, act="relu"), 4)  # every ACT_FNS name
    assert not ds.fused_step_eligible(layers, tfm.LayerConfig.make(D, n_heads=2, act="tanh"), 4)  # no other
    no_cross = [{k: v for k, v in lp.items() if k not in ("ca", "ca_norm")} for lp in layers]
    assert ds.fused_step_eligible(no_cross, lc, 4) and not ds.fused_step_eligible(no_cross, lc, 4, cross=True)
    cfg, _, t5_layers = _t5_layers()  # GEGLU mlp.{w, v, wo}: served only as gated
    assert ds.fused_step_eligible(t5_layers, cfg.layer, 4, cross=True, gated=True)
    assert not ds.fused_step_eligible(t5_layers, cfg.layer, 4, cross=True)
    assert not ds.fused_step_eligible(layers, lc, 4, cross=True, gated=True)


# ---------------------------------------------------------------------------
# the slice end to end: the generators with USE_FUSED_STEP on both sides
# ---------------------------------------------------------------------------


class Tok:
    def __init__(self, eos=None):
        self.eos_token_id = eos


GPT_VOCAB, GPT_CTX = 300, 128
GPT_PROMPTS = [[5, 6, 7], [9] * 40, [11, 12], list(range(20, 41))]


def _gpt2_state_dict(seed=7, w=0.3):
    """Synthetic HF GPT-2 weights; the layers' matrices at 0.3 and position
    embeddings at 1.0 (a checkpoint's are ~0.02-0.1), so that the greedy
    streams move instead of repeating the prompt's last token."""
    r = np.random.default_rng(seed)

    def rn(*shape, s=0.02):
        return (r.standard_normal(shape) * s).astype(np.float32)

    sd = {"wte.weight": rn(GPT_VOCAB, D, s=0.5), "wpe.weight": rn(GPT_CTX, D, s=1.0),
          "ln_f.weight": 1 + rn(D), "ln_f.bias": rn(D)}
    for i in range(N_LAYERS):
        p = f"h.{i}"
        sd |= {f"{p}.ln_1.weight": 1 + rn(D), f"{p}.ln_1.bias": rn(D),
               f"{p}.ln_2.weight": 1 + rn(D), f"{p}.ln_2.bias": rn(D),
               f"{p}.attn.c_attn.weight": rn(D, 3 * D, s=w), f"{p}.attn.c_attn.bias": rn(3 * D),
               f"{p}.attn.c_proj.weight": rn(D, D, s=w), f"{p}.attn.c_proj.bias": rn(D),
               f"{p}.mlp.c_fc.weight": rn(D, 4 * D, s=w), f"{p}.mlp.c_fc.bias": rn(4 * D),
               f"{p}.mlp.c_proj.weight": rn(4 * D, D, s=w), f"{p}.mlp.c_proj.bias": rn(D)}
    return sd


def _small_gpt2(cls, **kw):
    old = (cls.vocab_size, cls.max_seq_len)
    cls.vocab_size, cls.max_seq_len = GPT_VOCAB, GPT_CTX
    try:
        return cls(N_LAYERS, D, **kw)
    finally:
        cls.vocab_size, cls.max_seq_len = old


@pytest.fixture(scope="module")
def gpt2_models():
    ref = _small_gpt2(jax_text.GPT2)
    ref.load_hf_state_dict(_gpt2_state_dict())
    ours = _small_gpt2(GPT2, device="cpu")
    ours.params = from_jax_params(jax.tree.map(to_np, ref.params))
    return ref, ours


def test_gpt2_generate_tokens_batch_fused_matches_jax(gpt2_models, fused_on):
    ref, ours = gpt2_models
    with pltpu.force_tpu_interpret_mode():
        expected = jax_text.DecoderGenerator(ref, Tok()).generate_tokens_batch(GPT_PROMPTS, max_tokens=10)
        eos = expected[0][len(GPT_PROMPTS[0]) + 2]  # a token the model really emits: rows stop apart
        expected_eos = jax_text.DecoderGenerator(ref, Tok(eos)).generate_tokens_batch(GPT_PROMPTS, max_tokens=10)
    assert DecoderGenerator(ours, Tok()).generate_tokens_batch(GPT_PROMPTS, max_tokens=10) == expected
    got = DecoderGenerator(ours, Tok(eos)).generate_tokens_batch(GPT_PROMPTS, max_tokens=10)
    assert got == expected_eos and any(len(g) < len(p) + 10 for g, p in zip(got, GPT_PROMPTS))
    assert all(len(set(row[len(p):])) >= 3 for row, p in zip(expected, GPT_PROMPTS))


def test_gpt2_generate_tokens_fused_matches_jax(gpt2_models, fused_on):
    """A single prompt runs as a batch of one with bucket padding, as in
    JAX: a 70-token prompt pads to the 128-token context and generates
    nothing, where the per-op route generates up to the context."""
    ref, ours = gpt2_models
    prompts = [[5, 6, 7], list(range(1, 71))]
    with pltpu.force_tpu_interpret_mode():
        expected = [jax_text.DecoderGenerator(ref, Tok()).generate_tokens(p, max_tokens=9) for p in prompts]
    gen = DecoderGenerator(ours, Tok())
    assert [gen.generate_tokens(p, max_tokens=9) for p in prompts] == expected
    assert expected[1] == prompts[1]
    attn.USE_FUSED_STEP = False
    assert len(gen.generate_tokens(prompts[1], max_tokens=9)) == 79  # per-op: no bucket padding


def test_gpt2_fused_hidden_step_matches_per_op(gpt2_models, fused_on):
    """The headless fused step's final hidden state == the per-op step's."""
    _, ours = gpt2_models
    params, cfg = ours.params, ours.cfg
    r = np.random.default_rng(11)
    prompt = torch.from_numpy(r.integers(0, GPT_VOCAB, (2, 64)))
    pads = torch.tensor([3, 0], dtype=torch.int32)
    pos_ids = (torch.arange(64)[None, :] - pads[:, None].long()).clamp_min(0)
    flat, _ = dlm.decoder_lm_make_cache(cfg, (2,))
    views, stacked = dlm.decoder_lm_make_cache(cfg, (2,))
    dlm.decoder_lm_forward_cached_batch(params, cfg, prompt, pos_ids, flat, 0, pads)
    dlm.decoder_lm_forward_cached_batch(params, cfg, prompt, pos_ids, views, 0, pads)
    tok, p_ids = prompt[:, -1:], (64 - pads.long())[:, None]
    ref, _ = dlm.decoder_lm_hidden_cached_batch(params, cfg, tok, p_ids, flat, 64, pads)
    packed, _ = dlm.decoder_lm_pack(params, cfg)
    got = dlm.decoder_lm_hidden_fused_batch(params, packed, cfg, tok, p_ids, stacked, 64, pads)
    torch.testing.assert_close(got, ref, rtol=0, atol=X_TOL)
    torch.testing.assert_close(stacked["k"][:, :, 64], torch.stack([c["k"][:, 64] for c in flat]), rtol=0, atol=KV_TOL)


W_VOCAB, W_INIT, W_MAX = 100, [1, 2], 14


def _whisper_state_dict(seed=101, s=0.3):
    """Synthetic OpenAI-layout weights at d_model 128 (2 heads of 64), larger
    than a checkpoint's so the greedy streams move (tests/test_torch_whisper.py)."""
    r = np.random.default_rng(seed)
    nm = 80

    def rn(*shape, scale=s):
        return (r.standard_normal(shape) * scale).astype(np.float32)

    sd = {"encoder.conv1.weight": rn(D, nm, 3), "encoder.conv1.bias": rn(D),
          "encoder.conv2.weight": rn(D, D, 3), "encoder.conv2.bias": rn(D),
          "encoder.positional_embedding": rn(1500, D),
          "decoder.token_embedding.weight": rn(W_VOCAB, D, scale=1.0),
          "decoder.positional_embedding": rn(448, D, scale=3.0),
          "encoder.ln_post.weight": 1 + rn(D, scale=0.02), "encoder.ln_post.bias": rn(D, scale=0.02),
          "decoder.ln.weight": 1 + rn(D, scale=0.02), "decoder.ln.bias": rn(D, scale=0.02)}
    for side in ("encoder", "decoder"):
        for i in range(N_LAYERS):
            pfx = f"{side}.blocks.{i}"
            kinds = ("attn", "cross_attn") if side == "decoder" else ("attn",)
            for kind in kinds:
                a = f"{pfx}.{kind}"
                sd |= {f"{a}.query.weight": rn(D, D), f"{a}.query.bias": rn(D), f"{a}.key.weight": rn(D, D),
                       f"{a}.value.weight": rn(D, D), f"{a}.value.bias": rn(D),
                       f"{a}.out.weight": rn(D, D), f"{a}.out.bias": rn(D),
                       f"{a}_ln.weight": 1 + rn(D, scale=0.02), f"{a}_ln.bias": rn(D, scale=0.02)}
            sd |= {f"{pfx}.mlp.0.weight": rn(4 * D, D), f"{pfx}.mlp.0.bias": rn(4 * D),
                   f"{pfx}.mlp.2.weight": rn(D, 4 * D), f"{pfx}.mlp.2.bias": rn(D),
                   f"{pfx}.mlp_ln.weight": 1 + rn(D, scale=0.02), f"{pfx}.mlp_ln.bias": rn(D, scale=0.02)}
    return sd


def test_whisper_transcribe_fused_matches_jax(fused_on):
    dims = dict(vocab_size=W_VOCAB, n_layers=N_LAYERS, d_model=D, n_mels=80)
    ref = jax_a2t.Whisper(**dims)
    ref.load_openai_state_dict(_whisper_state_dict())
    ours = Whisper(**dims, device="cpu")
    ours.params = from_jax_params(jax.tree.map(to_np, ref.params))
    r = np.random.default_rng(7)
    t = np.arange(5 * 16000) / 16000
    audios = [(0.5 * np.sin(2 * np.pi * 440 * t[:3 * 16000]) + 0.05 * r.standard_normal(3 * 16000)).astype(np.float32),
              (0.3 * r.standard_normal(5 * 16000) * np.sin(2 * np.pi * 3 * t)).astype(np.float32)]
    with pltpu.force_tpu_interpret_mode():
        expected = jax_a2t.WhisperGenerator(ref).transcribe_tokens_batch(audios, W_INIT, -1, W_MAX)
    got = WhisperGenerator(ours).transcribe_tokens_batch(audios, W_INIT, -1, W_MAX)
    assert got == expected
    assert expected[0] != expected[1] and all(len(set(row[len(W_INIT):])) >= 3 for row in expected)


# csrc/decode_step.cuh ``Args`` before ``stamps``, field by field: fields are only
# ever appended (``stamps`` last), so a library built from an older tree reads
# this structure's prefix unchanged (kernel_ab.py --k7 times both in one call)
_ARGS_BEFORE_STAMPS = (
    [(n, 8) for n in ("x", "x_out", "wqkv", "bqkv", "wo", "bo", "w1", "b1", "w2", "b2", "ln1_s", "ln1_b", "ln2_s",
                      "ln2_b", "wqc", "bqc", "woc", "boc", "lnc_s", "lnc_b", "k_cache", "v_cache", "pads", "xk", "xv",
                      "xlens", "sbias", "emb", "fn_s", "fn_b", "tok", "workspace", "stream", "s_qkv", "s_o", "s_1",
                      "s_2", "s_qc", "s_oc", "ks", "vs", "xks", "xvs", "emb_s", "tok_emb", "pos_emb", "tok_ids",
                      "pos_ids")]
    + [(n, 4) for n in ("n_layers", "b", "d", "hd", "dff", "n_heads", "l_max", "lx", "pos", "vocab", "act", "dtype",
                        "has_cross", "has_head", "norm", "gated", "wt_int8", "a8", "kv_int8", "kvx_int8", "head_a8",
                        "embed", "tok_rows", "pos_rows", "eps", "scale")])


def test_step_args_keep_every_earlier_field_at_its_offset():
    off = 0
    for name, size in _ARGS_BEFORE_STAMPS:
        assert getattr(ds._Args, name).offset == off, name
        assert getattr(ds._Args, name).size == size, name
        off += size
    names = [f[0] for f in ds._Args._fields_]
    assert names[:len(_ARGS_BEFORE_STAMPS)] == [n for n, _ in _ARGS_BEFORE_STAMPS]
    assert names[-1] == "stamps" and len(names) == len(_ARGS_BEFORE_STAMPS) + 1
    assert ds._Args.stamps.offset == off == 488 and ds._Args.stamps.size == 8
    assert ctypes.sizeof(ds._Args) == 496


@pytest.mark.parametrize("cross,head,n", [(False, True, 12 * 5 + 2), (True, True, 8 * 8 + 2), (True, False, 24)])
def test_step_phase_kinds_follow_the_kernels_barriers(cross, head, n):
    layers = {62: 12, 66: 8, 24: 3}[n]
    kinds = ds.step_phase_kinds(layers, cross, head)
    assert len(kinds) == n
    assert kinds[:5 + 3 * cross] == ["qkv", "attn", "o"] + (["qc", "xattn", "oc"] if cross else []) + ["fc1", "fc2"]
    assert kinds[-2:] == (["head", "argmax"] if head else ["fc1", "fc2"])


def test_phase_breakdown_takes_the_worst_block_and_the_median_phase():
    # 2 launches x 3 phases (kinds a, b, a) x 2 blocks; ns stamps: start, after load, after compute, before barrier
    st = torch.zeros(2, 3, 2, 4, dtype=torch.int64)
    for launch in range(2):
        t0 = 1_000_000 * launch
        for p in range(3):
            for blk in range(2):
                start = t0 + p * 10_000 + blk * 500  # block 1 leaves each barrier 0.5 us later
                load, comp, epi = 1_000 * (p + 1), 3_000 + 1_000 * blk, 500
                st[launch, p, blk] = torch.tensor([start, start + load, start + load + comp,
                                                   start + load + comp + epi])
    bd = ds.phase_breakdown(st, ["a", "b", "a"])
    assert bd["a"]["n"] == 2 and bd["b"]["n"] == 1
    assert bd["b"]["load"] == pytest.approx(2.0) and bd["a"]["compute"] == pytest.approx(4.0)
    assert bd["a"]["epilogue"] == pytest.approx(0.5)
    # wait of phase p: its start minus the same block's arrival at the end of phase p - 1 (block 0: 10 - 4.5),
    # none for phase 0 (a's wait: phase 2 only, max(20 - 15.5, 20.5 - 17))
    assert bd["b"]["wait"] == pytest.approx(5.5) and bd["a"]["wait"] == pytest.approx(4.5)
    assert bd["a"]["load"] == pytest.approx(2.0)  # phases 0 and 2: loads 1 and 3
    assert bd["b"]["barrier"] == pytest.approx(4.5) and bd["b"]["busy"] == pytest.approx(6.5)
    assert bd["step"] == pytest.approx((20_000 + 500 + 3_000 + 4_000 + 500) / 1e3)


@pytest.mark.parametrize("dtype,cu", [(torch.float32, 4), (torch.bfloat16, 8), (torch.int8, 8)])
def test_unit_major_weights_keep_each_column_unit_contiguous(dtype, cu):
    """The kernel reads a packed (L, K, N) weight as (L, N / cu, K, cu): one
    lane's column vector per unit, its K rows contiguous; the copy is made
    once per tensor, again after an in-place change, and for inference
    tensors (the generators pack under inference_mode); a slice of whole
    layers reads the same slice of the whole tensor's copy."""
    w = torch.arange(2 * 64 * 128).reshape(2, 64, 128).to(dtype)
    u = ds._unit_major(w)
    assert u.shape == (2, 128 // cu, 64, cu) and u.is_contiguous()
    assert torch.equal(u[1, 3, 5], w[1, 5, 3 * cu:4 * cu])
    assert ds._unit_major(w) is u
    w.add_(1)
    assert torch.equal(ds._unit_major(w)[0, 0, 0], w[0, 0, :cu])
    with torch.inference_mode():
        wi = w.clone()
        ui = ds._unit_major(wi)
        assert ds._unit_major(wi) is ui and torch.equal(ui, ds._unit_major(w))
    layer = ds._unit_major(w[1:2])  # a layer's slice: a view of the whole tensor's copy, made once
    assert layer._base is ds._unit_major(w) and torch.equal(layer[0], ds._unit_major(w)[1])
