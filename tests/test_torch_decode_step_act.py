"""The fused decode step (K7) with the MLP activations beyond GELU (relu,
silu, identity), the port's plain twin against the JAX kernel in interpret
mode, on the CPU.

The JAX kernel applies ``KERNEL_ACT_FNS[act]`` to compute-dtype values
after the fp32 bias: to the plain MLP's hidden and, in the gated MLP, to
the gate, ``act(a) * g``. Its gate admits every ``ACT_FNS`` name; so does
the port's. Three variants: base (GPT-2 style, LayerNorm, tied head),
cross (Whisper style) and gated (T5's RMSNorm, GEGLU, rel-pos self bias,
untied head), in fp32 and bf16, at the sizes of
tests/test_torch_decode_step.py (2 layers, d 128, 2 heads of 64).

Tolerances: fp32 ``x_out`` within that file's 2e-4 (3e-4 for the gated
variant, as its T5 test), the K/V written at ``pos`` within 2e-5 and the
greedy tokens exactly. bf16 within the K7 limits chip_smoke.py holds the
kernel to (``DS_TOL``: atol 2^-3, rtol 2^-5): the JAX kernel rounds
``k * q`` and the probabilities to bf16 where the port keeps fp32, so the
two part by bf16 steps. Each case also checks that the activation matters:
the twin with any other ``ACT_FNS`` name in its place lands more than twice
as far from the JAX kernel.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import pytorch_models_tpu.models.text as jax_text
import pytorch_models_tpu.ops.decode_step as jax_ds
import pytorch_models_tpu.transformer as jax_tfm
from pytorch_models_tpu.models.text import t5 as jax_t5
from pytorch_models_tpu.ops.layers import ACT_FNS
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch import transformer as tfm
from pytorch_models_tpu_torch.models.text import GPT2, DecoderGenerator
from pytorch_models_tpu_torch.ops import decode_step as ds
from pytorch_models_tpu_torch.utils import from_jax_params
from tests.test_torch_decode_step import (GPT_PROMPTS, KV_TOL, X_TOL, Tok, _caches, _gpt2_state_dict, _small_gpt2,
                                          _t5_layers)
from tests.test_torch_decode_step import fused_on  # noqa: F401  (a fixture)

torch.set_num_threads(1)

B, D, N_LAYERS = 4, 128, 2
ACTS = ("relu", "silu", "identity")
BF16_TOL = (2.0 ** -3, 2.0 ** -5)  # chip_smoke.py DS_TOL["bfloat16"]: atol, rtol
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(kind: str, dn: str) -> tuple[float, float]:
    if dn == "bfloat16":
        return BF16_TOL
    return (3e-4, 3e-4) if kind == "gated" else (X_TOL, X_TOL)


def _to(a, dt) -> torch.Tensor:
    """A JAX or numpy array as a torch tensor of ``dt`` (bf16 arrays pass
    through fp32, exactly)."""
    return torch.from_numpy(np.asarray(jnp.asarray(a).astype(jnp.float32))).to(dt)


def _case(kind: str, dn: str, act: str, seed: int = 0):
    """The JAX kernel's outputs and a function running the port's twin on
    the same inputs with a given activation."""
    r = np.random.default_rng(300 + seed)
    tdt, jdt = DTYPES[dn]
    pos, l_max, l_mem = 37, 128, 24
    x = jnp.asarray(r.standard_normal((B, D)).astype(np.float32), jdt)
    k, v = (jnp.asarray(c, jdt) for c in _caches(r, l_max))
    pads = np.asarray([0, 2, 37, 1], np.int32)
    valid = np.asarray([24, 9, 24, 3], np.int32)
    fs = (1 + 0.1 * r.standard_normal(D)).astype(np.float32)
    jkw, kw, head_kw = {}, {}, {}
    if kind == "gated":
        cfg, dec, ours = _t5_layers()
        lc, jlayers, jp = cfg.layer, dec["layers"], dec
        table = jax_t5.relative_position_bias(dec["attn_bias"], jnp.arange(48), jnp.arange(l_max), False, cfg)
        sbias = np.ascontiguousarray(np.asarray(table)[:, pos, :].T)
        w = (0.3 * r.standard_normal((D, 300))).astype(np.float32)
        head, head_v = jax_ds.pack_greedy_head(jnp.asarray(w), {"scale": jnp.asarray(fs)}, jdt, tied=False)
        ours_head = ds.pack_greedy_head(torch.from_numpy(w), {"scale": torch.from_numpy(fs)}, tdt, tied=False)
        jkw = dict(norm="rms", gated=True, sbias=jnp.pad(jnp.asarray(sbias), ((0, 0), (0, 126))))
        kw = dict(norm="rms", gated=True, sbias=torch.from_numpy(sbias))
        eps = 1e-5
    else:
        lc = jax_tfm.LayerConfig.make(D, n_heads=2, cross_attn=kind == "cross")
        jp = jax_tfm.decoder_init(jax.random.PRNGKey(seed + 1), N_LAYERS, lc)
        ours = from_jax_params(jax.tree.map(to_np, jp))["layers"]
        jlayers = jp["layers"]
        emb = r.standard_normal((300, D)).astype(np.float32)
        head, head_v = jax_ds.pack_greedy_head(jnp.asarray(emb), {"scale": jnp.asarray(fs)}, jdt)
        ours_head = ds.pack_greedy_head(torch.from_numpy(emb), {"scale": torch.from_numpy(fs)}, tdt)
        eps = lc.norm_eps
        if kind == "cross":
            jkw = dict(norm="ln")
    if dn == "float32":  # greedy tokens compared in fp32 only (bf16 scores tie)
        head_kw = dict(head=head, head_v=head_v)
    cross = kind != "base"
    gated = kind == "gated"
    packed_j = jax_ds.pack_decode_weights(jlayers, jdt, cross=cross, gated=gated, **({"norm": "rms"} if gated else {}))
    packed = ds.pack_decode_weights(ours, tdt, cross=cross, gated=gated)
    if cross:
        memory = r.standard_normal((B, l_mem, D)).astype(np.float32)
        xc = jax_tfm.precompute_cross_caches(jp, lc, jnp.asarray(memory), valid_lens=jnp.asarray(valid))
        xk, xv = xc["k"].astype(jdt), xc["v"].astype(jdt)
    with pltpu.force_tpu_interpret_mode():
        if cross:
            out = jax_ds.fused_cross_decode_step(x, packed_j, k, v, xk, xv, xc["len"][0], pos, jnp.asarray(pads),
                                                 n_heads=2, act=act, eps=eps, **jkw, **head_kw)
        else:
            out = jax_ds.fused_decode_step(x, packed_j, k, v, pos, jnp.asarray(pads), n_heads=2, act=act, eps=eps,
                                           **head_kw)

    def twin(a):
        kc, vc = _to(k, tdt), _to(v, tdt)
        head_t = ours_head if head_kw else None
        if cross:
            x_out, tok = ds.fused_cross_decode_step(_to(x, tdt), packed, kc, vc, _to(xk, tdt), _to(xv, tdt),
                                                    torch.from_numpy(valid), pos, torch.from_numpy(pads), 2, a, eps,
                                                    head=head_t, **kw)
        else:
            x_out, tok = ds.fused_decode_step(_to(x, tdt), packed, kc, vc, pos, torch.from_numpy(pads), 2, a, eps,
                                              head=head_t)
        return x_out, tok, kc, vc

    return out, twin, pos


@pytest.mark.parametrize("dn", list(DTYPES))
@pytest.mark.parametrize("kind", ["base", "gated", "cross"])
@pytest.mark.parametrize("act", ACTS)
def test_fused_step_activation_matches_jax(act, kind, dn):
    out, twin, pos = _case(kind, dn, act)
    x_out, tok, kc, vc = twin(act)
    atol, rtol = _tol(kind, dn)
    ref = np.asarray(out[0].astype(jnp.float32))
    np.testing.assert_allclose(x_out.float().numpy(), ref, rtol=rtol, atol=atol)
    kv_tol = (KV_TOL, KV_TOL) if dn == "float32" else BF16_TOL
    for got, want in ((kc, out[1]), (vc, out[2])):
        np.testing.assert_allclose(got[:, :, pos].float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=kv_tol[1], atol=kv_tol[0])
    if dn == "float32":
        assert tok.tolist() == np.asarray(out[3]).tolist()
    err = np.abs(x_out.float().numpy() - ref).max()
    for other in set(ACT_FNS) - {act}:  # the activation is applied: any other in its place parts further from JAX
        assert np.abs(twin(other)[0].float().numpy() - ref).max() > 2 * err, other


def test_silu_twin_rounds_as_the_jax_kernel():
    """bf16 silu: x * sigmoid(x) with the sigmoid's exp, sum and reciprocal
    each rounded to bf16 is JAX's bf16 ``silu`` bit for bit on the CPU
    (one rounding of the fp32 silu is not); fp32 within an ulp or two."""
    x = np.random.default_rng(0).standard_normal(50_000).astype(np.float32) * 6
    xb = jnp.asarray(x, jnp.bfloat16)
    got = ds._act("silu", _to(xb, torch.bfloat16)).float().numpy()
    want = np.asarray(jax.jit(ACT_FNS["silu"])(xb).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)
    once = torch.nn.functional.silu(_to(xb, torch.float32)).to(torch.bfloat16).float().numpy()
    assert (once != want).any()
    np.testing.assert_allclose(ds._act("silu", torch.from_numpy(x)).numpy(), np.asarray(ACT_FNS["silu"](x)),
                               rtol=1e-6, atol=1e-6)
    for a in ("relu", "identity"):
        np.testing.assert_array_equal(ds._act(a, _to(xb, torch.bfloat16)).float().numpy(),
                                      np.asarray(ACT_FNS[a](xb).astype(jnp.float32)))


def test_every_act_name_is_eligible_in_both_packages():
    """Both gates admit every ``ACT_FNS`` name and refuse any other; the
    kernel's code of each name (bf16 serving takes tanh GELU for "gelu")."""
    _, _, ours = _t5_layers()
    lc = jax_tfm.LayerConfig.make(D, n_heads=2)
    jp = jax_tfm.decoder_init(jax.random.PRNGKey(0), N_LAYERS, lc)
    layers = from_jax_params(jax.tree.map(to_np, jp))["layers"]
    for act in ACT_FNS:
        assert ds.fused_step_eligible(layers, tfm.LayerConfig.make(D, n_heads=2, act=act), 4)
        assert jax_ds.fused_step_eligible(jp["layers"], lc.with_(act=act), 128)
    assert not ds.fused_step_eligible(layers, tfm.LayerConfig.make(D, n_heads=2, act="tanh"), 4)
    assert not jax_ds.fused_step_eligible(jp["layers"], lc.with_(act="tanh"), 128)
    assert [ds._act_code(a, torch.float32) for a in ACT_FNS] == [0, 1, 2, 3, 4]
    assert [ds._act_code(a, torch.bfloat16) for a in ACT_FNS] == [1, 1, 2, 3, 4]


def test_gpt2_silu_generate_tokens_batch_fused_matches_jax(fused_on, monkeypatch):  # noqa: F811
    """A small GPT-2 whose config takes ``act="silu"`` (both packages'
    ``DecoderLMConfig.act``) greedily decodes through the fused step on both
    sides: the same tokens, streams that move, every step with silu."""
    ref = _small_gpt2(jax_text.GPT2)
    ref.load_hf_state_dict(_gpt2_state_dict())
    ref.cfg = replace(ref.cfg, act="silu")
    ours = _small_gpt2(GPT2, device="cpu")
    ours.params = from_jax_params(jax.tree.map(to_np, ref.params))
    ours.cfg = replace(ours.cfg, act="silu")
    with pltpu.force_tpu_interpret_mode():
        expected = jax_text.DecoderGenerator(ref, Tok()).generate_tokens_batch(GPT_PROMPTS, max_tokens=10)
    acts, real = [], ds.fused_decode_step

    def spy(*a, **kw):
        acts.append(a[7])  # the wrapper's act
        return real(*a, **kw)

    monkeypatch.setattr(ds, "fused_decode_step", spy)  # the decoder LM imports it at each call
    assert DecoderGenerator(ours, Tok()).generate_tokens_batch(GPT_PROMPTS, max_tokens=10) == expected
    assert acts and set(acts) == {"silu"}
    assert all(len(set(row[len(p):])) >= 3 for row, p in zip(expected, GPT_PROMPTS))
