"""The ranks of the port's parallel tests (``tests/test_torch_parallel*.py``).

Each rank is a process spawned over gloo on the CPU (``init_method=file://``
in the test's temporary directory, one thread each). This module imports
only the port, never JAX: the parent test process computes the JAX and the
single-device references and hands the ranks the parameters as numpy trees.
``run_ranks`` joins every rank within a deadline; a rank that raises or
hangs fails the test, with the rank's traceback.
"""

from __future__ import annotations

import os
import queue
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, world: int, init_file: str, fn_name: str, args: tuple, out) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
        result = globals()[fn_name](rank, world, *args)
        out.put((rank, "ok", result))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the test
        out.put((rank, "error", traceback.format_exc()))


def run_ranks(runs: list, tmp_dir, timeout: float = 240.0) -> list:
    """Spawn every run of ``runs`` (``(world, fn_name, args)``) at once, each
    its own process group of ``world`` ranks calling ``fn_name(rank, world,
    *args)`` of this module. Returns per run the ranks' results, in rank
    order. Raises if a rank raises, or if the ranks are not all done within
    ``timeout`` seconds (every process is stopped first)."""
    ctx = mp.get_context("spawn")
    jobs = []
    for i, (world, fn_name, args) in enumerate(runs):
        out = ctx.Queue()
        init_file = os.path.join(str(tmp_dir), f"init_{i}")
        procs = [ctx.Process(target=_rank_main, args=(r, world, init_file, fn_name, args, out), daemon=True)
                 for r in range(world)]
        jobs.append((world, out, procs, {}))
    for _, _, procs, _ in jobs:
        for p in procs:
            p.start()
    deadline = time.monotonic() + timeout
    try:
        for world, out, procs, got in jobs:
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise AssertionError(f"ranks {sorted(set(range(world)) - set(got))} hung past {timeout} s")
                try:
                    rank, status, value = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise AssertionError(f"rank {dead[0]} died with exit code {procs[dead[0]].exitcode}")
                    continue
                if status == "error":
                    raise AssertionError(f"rank {rank} raised:\n{value}")
                got[rank] = value
        for _, _, procs, _ in jobs:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
                if p.exitcode != 0:
                    raise AssertionError(f"a rank exited with code {p.exitcode}")
    finally:
        for _, _, procs, _ in jobs:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
    return [[got[r] for r in range(world)] for world, _, _, got in jobs]


# ---------------------------------------------------------------------------
# models from the parent's numpy trees
# ---------------------------------------------------------------------------


class Tok:
    def __init__(self, eos: int = 9) -> None:
        self.eos_token_id = eos


def build(spec):
    """A port model on the CPU from ``(kind, constructor kwargs, numpy tree)``."""
    from pytorch_models_tpu_torch.utils import from_jax_params

    kind, kw, tree = spec
    if kind == "gpt2":
        from pytorch_models_tpu_torch.models.text import GPT2

        kw = dict(kw)
        saved = GPT2.vocab_size, GPT2.max_seq_len
        GPT2.vocab_size, GPT2.max_seq_len = kw.pop("vocab_size"), kw.pop("max_seq_len")
        try:
            m = GPT2(**kw, device="cpu")
        finally:
            GPT2.vocab_size, GPT2.max_seq_len = saved
    elif kind == "t5":
        from pytorch_models_tpu_torch.models.text import T5Model

        m = T5Model(**kw, device="cpu")
    else:
        from pytorch_models_tpu_torch.models.audio2text import Whisper

        m = Whisper(**kw, device="cpu")
    m.params = from_jax_params(tree)
    return m


def _mesh(world: int, shape: tuple, axes: tuple):
    from pytorch_models_tpu_torch.parallel import make_mesh

    return make_mesh(world, shape=shape, axes=axes, device="cpu")


# ---------------------------------------------------------------------------
# the cases, per rank
# ---------------------------------------------------------------------------


def serving_tp2(rank: int, world: int, m: dict, c: dict) -> dict:
    """tp=2 cases: the ("dp", "tp") = (1, 2) generator, the three pools, speculative decoding."""
    from pytorch_models_tpu_torch.parallel import TPContinuousBatchingGenerator, TPDecoderGenerator
    from pytorch_models_tpu_torch.parallel import TPSpeculativeGenerator
    from pytorch_models_tpu_torch.parallel.cb_serving import TPT5ContinuousBatchingGenerator
    from pytorch_models_tpu_torch.parallel.cb_serving import TPWhisperContinuousBatchingGenerator

    tp = _mesh(world, (2,), ("tp",))
    r = {"tp_only": TPDecoderGenerator(build(m["gpt2_128"]), Tok(), _mesh(world, (1, 2), ("dp", "tp")))
         .generate_tokens_batch(c["prompts"], max_tokens=6)}
    g256 = build(m["gpt2_256"])
    cb = TPContinuousBatchingGenerator(g256, Tok(), tp, batch_size=3, prompt_bucket=16, check_every=4)
    r["cb"] = cb.generate_tokens_many(c["cb_requests"], c["cb_budgets"])
    cb2 = TPContinuousBatchingGenerator(g256, Tok(), tp, batch_size=2, prompt_bucket=16, check_every=8)
    r["cb_epoch"] = cb2.generate_tokens_many(c["epoch_requests"], 40)
    r["cb_epoch_resets"] = cb2.last_stats.epoch_resets
    cb3 = TPContinuousBatchingGenerator(g256, Tok(), tp, batch_size=2, prompt_bucket=16, check_every=4)
    r["cb_prefix"] = cb3.generate_tokens_many(c["prefix_requests"], c["prefix_budgets"], shared_prefix=c["prefix"])
    r["cb_sample"] = cb3.generate_tokens_many(c["sample_requests"], c["sample_budgets"], **c["sample_kw"])
    r["cb_chunked"] = cb3.generate_tokens_many(c["long_requests"], c["long_budgets"])
    r["cb_chunked_prefix"] = cb3.generate_tokens_many(c["long_requests"], c["long_budgets"],
                                                      shared_prefix=c["long_prefix"])
    w = TPWhisperContinuousBatchingGenerator(build(m["whisper_128"]), tp, batch_size=2, check_every=3, pool_ctx=48)
    r["wcb"] = w.transcribe_tokens_many([np.asarray(a) for a in c["wcb_audios"]], c["wcb_init"], 63, max_tokens=10)
    t5 = TPT5ContinuousBatchingGenerator(build(m["t5_64"]), tp, batch_size=2, check_every=4, pool_ctx=64)
    r["t5cb"] = t5.generate_tokens_many(c["t5cb_requests"], 14, 0, 1)
    target, draft = build(m["gpt2_256_l4"]), build(m["gpt2_256_l2"])
    r["spec"] = TPSpeculativeGenerator(target, draft, Tok(), tp, k=3).generate_tokens(c["spec_prompt"], 16)
    r["spec_eos"] = [TPSpeculativeGenerator(target, target, Tok(eos), tp, k=4).generate_tokens(c["spec_prompt3"], 16)
                     for eos in c["spec_eos_ids"]]
    return r


def serving_world4(rank: int, world: int, m: dict, c: dict) -> dict:
    """dp x tp = 2 x 2 generators and tp=4 pools, speculative decoding and layouts."""
    from pytorch_models_tpu_torch.parallel import TPContinuousBatchingGenerator, TPDecoderGenerator
    from pytorch_models_tpu_torch.parallel import TPSpeculativeGenerator, TPT5Generator, TPWhisperGenerator
    from pytorch_models_tpu_torch.parallel.cb_serving import TPT5ContinuousBatchingGenerator

    tp = _mesh(world, (4,), ("tp",))
    dptp = _mesh(world, (2, 2), ("dp", "tp"))
    g128 = build(m["gpt2_128"])
    r = {"dp_tp": TPDecoderGenerator(g128, Tok(), dptp).generate_tokens_batch(c["prompts"], max_tokens=12),
         "sample": TPDecoderGenerator(g128, Tok(), dptp).generate_tokens_batch(c["prompts"], max_tokens=5, topk=3,
                                                                                seed=1),
         "t5": TPT5Generator(build(m["t5_128"]), object(), dptp).generate_tokens_batch(c["t5_prompts"], 10, 0, 1),
         "whisper": TPWhisperGenerator(build(m["whisper_128"]), dptp).transcribe_tokens_batch(
             [np.asarray(a) for a in c["w_audios"]], [1, 2], eot_id=-1, max_tokens=8)}
    g256 = build(m["gpt2_256"])
    cb = TPContinuousBatchingGenerator(g256, Tok(), tp, batch_size=3, prompt_bucket=16, check_every=4)
    r["cb"] = cb.generate_tokens_many(c["cb_requests"], c["cb_budgets"])
    gen = TPContinuousBatchingGenerator(g256, Tok(), tp, batch_size=2)
    r["pool_shapes"] = {k: tuple(t.shape) for k, t in gen._init_pool(*gen._params_cfg(), 2).stacked.items()}
    from pytorch_models_tpu_torch.models.text._decoder_lm import decoder_lm_fused_ok
    from pytorch_models_tpu_torch.ops import attention as attn
    from pytorch_models_tpu_torch.parallel import shard_decoder_lm_params

    attn.USE_FUSED_STEP = True
    try:  # the fused step's gate refuses the rank's layers, not the whole model's
        r["fused_gate"] = (decoder_lm_fused_ok(*gen._params_cfg(), 2), decoder_lm_fused_ok(g256.params, g256.cfg, 2))
    finally:
        attn.USE_FUSED_STEP = None
    lp = shard_decoder_lm_params(g256.params, tp)["decoder"]["layers"][1]
    r["gspmd_shapes"] = {name: tuple(lp[blk][lin][k].shape) for name, (blk, lin, k) in {
        "q.w": ("sa", "q", "w"), "q.b": ("sa", "q", "b"), "o.w": ("sa", "o", "w"), "fc1.w": ("mlp", "fc1", "w"),
        "fc2.w": ("mlp", "fc2", "w"), "fc2.b": ("mlp", "fc2", "b")}.items()}
    x = torch.tensor([float(rank), -float(rank)])
    r["collectives"] = (tp.psum(x.clone(), "tp").tolist(), tp.pmax(x.clone(), "tp").tolist(),
                        dptp.all_gather(torch.tensor([rank]), "dp").tolist(), dptp.index("dp"), dptp.index("tp"))
    r["t5cb"] = TPT5ContinuousBatchingGenerator(build(m["t5_64"]), tp, batch_size=2, check_every=4,
                                                pool_ctx=64).generate_tokens_many(c["t5cb_requests"], 14, 0, 1)
    target, draft = build(m["gpt2_256_l4"]), build(m["gpt2_256_l2"])
    spec = TPSpeculativeGenerator(target, draft, Tok(), tp, k=4)
    r["spec"] = spec.generate_tokens(c["spec_prompt"], 16)
    r["spec_q_shapes"] = (tuple(spec.params["decoder"]["layers"][0]["sa"]["q"]["w"].shape),
                          tuple(spec.draft_params["decoder"]["layers"][0]["sa"]["q"]["w"].shape))
    return r


def int8_tp2(rank: int, world: int, m: dict, c: dict) -> dict:
    """The tp=2 int8 pools (GPT-2 self, Whisper self + cross, T5 cross), the
    K6 launches with the full-width scale counted through its plain version
    (CPU tensors), and ``quantize_rows(group=)`` on each rank's half of
    ``c["rows"]``."""
    from pytorch_models_tpu_torch.ops import attention as attn
    from pytorch_models_tpu_torch.ops import int8_kv
    from pytorch_models_tpu_torch.parallel import TPContinuousBatchingGenerator
    from pytorch_models_tpu_torch.parallel.cb_serving import TPT5ContinuousBatchingGenerator
    from pytorch_models_tpu_torch.parallel.cb_serving import TPWhisperContinuousBatchingGenerator

    tp = _mesh(world, (2,), ("tp",))
    plain = int8_kv.int8_decode_attention_plain
    calls = {"cur_ks": 0, "cross": 0}

    def spy(*a, **kw):  # the wrapper passes its arguments on in order: cur_ks is the 12th
        cur_ks = a[11] if len(a) > 11 else kw.get("cur_ks")
        calls["cur_ks" if cur_ks is not None else "cross"] += 1
        return plain(*a, **kw)

    int8_kv.int8_decode_attention_plain = spy
    r = {}
    try:
        attn.USE_INT8_KV = True
        gen = TPContinuousBatchingGenerator(build(m["gpt2_256"]), Tok(), tp, batch_size=2, prompt_bucket=16,
                                            check_every=4)
        r["gpt_gate"] = gen._use_int8_pool(gen._params_cfg()[1], 2, False)
        r["gpt"] = gen.generate_tokens_many(c["requests"], c["budgets"])
        r["gpt_calls"] = dict(calls)
        attn.USE_INT8_KV_CROSS = True
        w = TPWhisperContinuousBatchingGenerator(build(m["whisper_256"]), tp, batch_size=2, check_every=4,
                                                 pool_ctx=64)
        r["whisper_modes"] = w._int8_modes(w._params_cfg()[1], 2, False)
        r["whisper"] = w.transcribe_tokens_many([np.asarray(a) for a in c["audios"]], c["init"], c["eot"],
                                                max_tokens=12)
        attn.USE_INT8_KV = False
        t5 = TPT5ContinuousBatchingGenerator(build(m["t5_256"]), tp, batch_size=2, check_every=4, pool_ctx=64)
        r["t5_modes"] = t5._int8_modes(*t5._params_cfg(), 2, 64)
        r["t5"] = t5.generate_tokens_many(c["t5_requests"], 12, 0, 1)
        r["calls"] = dict(calls)
    finally:
        attn.USE_INT8_KV = attn.USE_INT8_KV_CROSS = False
        int8_kv.int8_decode_attention_plain = plain
    rows = torch.from_numpy(c["rows"])
    half = rows.shape[-1] // 2
    q8, sc = int8_kv.quantize_rows(rows[..., rank * half:(rank + 1) * half], group=tp.group("tp"))
    r["levels"], r["scales"] = q8.numpy(), sc.numpy()
    return r


def int8_cache_tp4(rank: int, world: int, gpt2: tuple) -> dict:
    """The int8 pool's layout at tp=4 (the pool quantized as the single-device
    int8 pool is, whatever the width gate says) and the width gate there."""
    from pytorch_models_tpu_torch.ops import attention as attn
    from pytorch_models_tpu_torch.ops.int8_kv import quantize_kv_caches
    from pytorch_models_tpu_torch.parallel import TPContinuousBatchingGenerator

    gen = TPContinuousBatchingGenerator(build(gpt2), Tok(), _mesh(world, (4,), ("tp",)), batch_size=2)
    i8 = quantize_kv_caches(gen._init_pool(*gen._params_cfg(), 2).stacked)
    attn.USE_INT8_KV = True
    try:
        gate = gen._use_int8_pool(gen._params_cfg()[1], 2, False)
    finally:
        attn.USE_INT8_KV = False
    return {"shapes": {k: (tuple(t.shape), str(t.dtype)) for k, t in i8.items()}, "int8_pool": gate}


# ---------------------------------------------------------------------------
# pipeline- and expert-parallel serving, the training step
# ---------------------------------------------------------------------------


def pp_ep_serving(rank: int, world: int, m: dict, c: dict) -> dict:
    """The PP, TP x PP and EP generators of this world's meshes (2, 4 or 8
    ranks), each on the parent's prompts; the all_to_all calls of each EP
    run; the shard shapes of a rank's stage and caches."""
    from pytorch_models_tpu_torch.parallel import PPDecoderGenerator, TPPPDecoderGenerator
    from pytorch_models_tpu_torch.parallel.ep_serving import EPMoEGenerator, MoEDecoderConfig
    from pytorch_models_tpu_torch.parallel.mesh import all_to_all
    from pytorch_models_tpu_torch.utils import from_jax_params

    r = {}
    for key, pp in c["pp"].get(world, []):
        gen = PPDecoderGenerator(build(m[key]), Tok(), _mesh(world, (pp,), ("pp",)))
        r[f"pp{pp}"] = gen.generate_tokens_batch(c["prompts"], max_tokens=8)
        r[f"pp{pp}_layers"] = [len(s) for s in gen.params["decoder"]["layers"]]
    for shape in c["tp_pp"].get(world, []):
        axes = ("pp", "tp") if len(shape) == 2 else ("dp", "pp", "tp")
        gen = TPPPDecoderGenerator(build(m["gpt2_256_l4"]), Tok(), _mesh(world, shape, axes))
        r[shape] = gen.generate_tokens_batch(c["prompts"], max_tokens=8)
        lp = gen.params["decoder"]["layers"][0][0]
        r[(shape, "shards")] = (len(gen.params["decoder"]["layers"]), len(gen.params["decoder"]["layers"][0]),
                                tuple(lp["sa"]["q"]["w"].shape), tuple(lp["sa"]["o"]["w"].shape),
                                tuple(gen.params["token_embs"].shape))
    if world == 4:
        gen = TPPPDecoderGenerator(build(m["gpt2_256_l4"]), Tok(c["eos"]), _mesh(world, (2, 2), ("pp", "tp")))
        r["tp_pp_eos"] = gen.generate_tokens_batch(c["eos_prompts"], max_tokens=12)
    for name, ep, kw in c["ep"].get(world, []):
        cfg = MoEDecoderConfig(**c["ep_cfg"])
        gen = EPMoEGenerator(from_jax_params(m[name]), cfg, _mesh(world, (ep,), ("ep",)))
        before = all_to_all.calls
        r[(name, ep)] = gen.generate_tokens_batch(c["ep_prompts"][name], **kw)
        r[(name, ep, "all_to_all")] = all_to_all.calls - before
        r[(name, ep, "w1")] = tuple(gen.params["layers"][0]["w1"].shape)
    for label, (name, ep, prompts, kw) in c.get("ep_short", {}).get(world, {}).items():
        gen = EPMoEGenerator(from_jax_params(m[name]), MoEDecoderConfig(**c["ep_cfg"]), _mesh(world, (ep,), ("ep",)))
        try:
            r[("short", label)] = gen.generate_tokens_batch(prompts, **kw)
        except ValueError as e:
            r[("short", label)] = repr(e)
    return r


class OneRank:
    """A mesh of one rank (no process group): the single-device trainer."""

    shape: dict = {"dp": 1, "pp": 1, "tp": 1}
    device = torch.device("cpu")

    def size(self, axis: str) -> int:
        return 1

    def index(self, axis: str) -> int:
        return 0

    def group(self, axis: str):
        return None


def train_ranks(rank: int, world: int, c: dict) -> dict:
    """The train step's cases on a (dp, pp, tp) mesh of this world: two SGD
    steps from the parent's parameters (each rank's shard of the stepped
    parameters, its gradient leaves' finiteness and non-zero share), the
    pipelined forward's logits and the EP dispatch at high capacity."""
    import dataclasses

    from pytorch_models_tpu_torch.parallel.sharding import shard_params, tree_map_with_path
    from pytorch_models_tpu_torch.parallel.train import (MoELMConfig, _loss_and_grads, _moe_mlp_sparse_ep,
                                                         make_train_step, moe_lm_forward, moe_lm_from_jax,
                                                         param_pspecs)

    shape = c["shapes"][world]
    mesh = _mesh(world, shape, ("dp", "pp", "tp"))
    r = {"index": tuple(mesh.index(a) for a in ("dp", "pp", "tp"))}
    if c.get("collectives"):
        r["collectives"] = _collectives(rank, _mesh(world, (world,), ("tp",)))
    for name, kw in c["train"].items():
        cfg = MoELMConfig(**kw)
        step, specs = make_train_step(cfg, mesh, n_micro=2)
        params = shard_params(moe_lm_from_jax(c["params"][name]), specs, mesh)
        tokens = torch.from_numpy(c["tokens"][name])
        loss, grads = _loss_and_grads(params, cfg, tokens, mesh, 2)
        params, loss0 = step(params, tokens)
        params, loss1 = step(params, tokens)
        flat = []
        tree_map_with_path(lambda p, g: flat.append((p, bool(torch.isfinite(g).all()), float(g.abs().max()))), grads)
        r[name] = {"losses": (float(loss0), float(loss1)), "grads_loss": float(loss), "grads": flat,
                   "params": tree_map_with_path(lambda p, t: t.numpy(), params)}
    high = dataclasses.replace(MoELMConfig(), capacity_factor=float(MoELMConfig.n_experts))
    for key, cfg in (("forward", MoELMConfig()), ("forward_high", high)):
        if key in c["params"]:
            params = shard_params(moe_lm_from_jax(c["params"][key]), param_pspecs(cfg), mesh)
            with torch.no_grad():
                r[key] = moe_lm_forward(params, cfg, torch.from_numpy(c["tokens"]["forward"]), mesh, 2).numpy()
    if "ep_x" in c:  # the first block of the rank's stage
        cfg = high
        lp = shard_params(moe_lm_from_jax(c["params"]["ep"]), param_pspecs(cfg), mesh)["stages"][0][0]
        x = torch.from_numpy(c["ep_x"])
        dp, tp = mesh.index("dp"), mesh.index("tp")
        mb, lt = x.shape[0] // shape[0], x.shape[1] // shape[2]
        with torch.no_grad():
            r["ep_out"] = _moe_mlp_sparse_ep(lp, cfg, x[dp * mb:(dp + 1) * mb, tp * lt:(tp + 1) * lt], mesh).numpy()
    return r


def _collectives(rank: int, mesh) -> dict:
    """Each collective of ``parallel/mesh.py`` on one line of ranks, and the
    gradients its autograd pair sends back, on small tensors made from the
    rank's index."""
    from pytorch_models_tpu_torch.parallel.mesh import (all_gather_grad, all_to_all_grad, copy_to_group,
                                                        reduce_from_group, reduce_scatter_grad)

    g, n = mesh.group("tp"), mesh.shape["tp"]
    w = torch.arange(n * n, dtype=torch.float32).reshape(n, n)
    x = (torch.arange(n, dtype=torch.float32) + 10 * rank).requires_grad_()
    gathered = all_gather_grad(x[None], g, dim=0)
    (gathered * w).sum().backward()
    y = (torch.arange(n, dtype=torch.float32) + rank).requires_grad_()
    scattered = reduce_scatter_grad(y, g, dim=0)
    (scattered.sum() * (rank + 1)).backward()
    t = (torch.arange(n, dtype=torch.float32) + 100 * rank).requires_grad_()
    exchanged = all_to_all_grad(t, g)
    (exchanged * torch.arange(n)).sum().backward()
    v = torch.ones(2, requires_grad=True)
    (copy_to_group(v, g).sum() * (rank + 1)).backward()
    u = torch.full((2,), float(rank), requires_grad=True)
    summed = reduce_from_group(u, g)
    summed.sum().backward()
    absent = []
    for what in (mesh.group, mesh.index):
        try:
            what("dp")
        except KeyError:
            absent.append(what.__name__)
    ring = mesh.recv(x, "tp", (rank - 1) % n) if rank % 2 else None
    mesh.send(x.detach() + 1, "tp", (rank + 1) % n)
    if rank % 2 == 0:
        ring = mesh.recv(x, "tp", (rank - 1) % n)
    return {"gathered": gathered.tolist(), "x.grad": x.grad.tolist(), "scattered": scattered.tolist(),
            "y.grad": y.grad.tolist(), "exchanged": exchanged.tolist(), "t.grad": t.grad.tolist(),
            "v.grad": v.grad.tolist(), "summed": summed.tolist(), "u.grad": u.grad.tolist(),
            "broadcast": mesh.broadcast(torch.tensor([float(rank)]), "tp", 2).tolist(), "ring": ring.tolist(),
            "absent axis": (absent, mesh.size("dp"))}
