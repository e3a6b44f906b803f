"""The sharded serving matrix on the PyTorch port, one process per rank over
torch.distributed.

    python examples/torch_serve_sharded.py          # 8 ranks sharing the CUDA card (gloo)
    python examples/torch_serve_sharded.py --cpu    # 8 ranks on the CPU (gloo)

The port's counterpart of serve_sharded.py: the same models, prompts,
meshes, checks and printed lines. The script spawns its own ranks: a world
of 8 for the meshes of 8 (dp x tp, dp x pp x tp), whose first 4 ranks then
form a world of 4 for the meshes of 4 (pp, tp speculative, the tp
continuous-batching pool). Every rank returns every row, and each must be
token-identical to the single-device DecoderGenerator — sharding is an
execution detail, never a numerics change.
"""

import copy
import os
import sys
import tempfile
import time

sys.path.insert(0, ".")
from examples._torch_common import setup  # noqa: E402

WORLD = 8
JOIN_S = 900  # the ranks' time limit, their start included
PROMPTS = [[5, 6, 7], [9] * 12, [11, 12], [3] * 7]
SYS_PROMPT = [2, 7, 1, 8]


class Tok:
    eos_token_id = None


def _gpt2(**kw):
    """serve_sharded.py's GPT-2 shape: vocab 512, context 256."""
    from pytorch_models_tpu_torch.text import GPT2

    saved = GPT2.vocab_size, GPT2.max_seq_len
    GPT2.vocab_size, GPT2.max_seq_len = 512, 256
    try:
        return GPT2(**kw)
    finally:
        GPT2.vocab_size, GPT2.max_seq_len = saved


def _moved(model, device):
    """A shallow copy of ``model`` whose parameters lie on ``device``."""
    import torch

    from pytorch_models_tpu_torch.utils import tree_map

    out = copy.copy(model)
    out.params = tree_map(lambda t: t.to(device), model.params)
    out.device = torch.device(device)
    return out


def _launches() -> dict:
    """The launch counts of the kernels the serving paths can reach."""
    from pytorch_models_tpu_torch.ops.decode_attention import decode_attention
    from pytorch_models_tpu_torch.ops.decode_step import fused_cross_decode_step, fused_decode_step
    from pytorch_models_tpu_torch.ops.gather import embed_add, gather_rows
    from pytorch_models_tpu_torch.ops.greedy_head import greedy_argmax_tied

    return {fn.__name__: fn.launches for fn in (decode_attention, embed_add, gather_rows, greedy_argmax_tied,
                                                 fused_decode_step, fused_cross_decode_step)}


def _rank(rank: int, init_dir: str, cpu: bool, model, draft, out) -> None:
    """One rank: the meshes of 8, then (ranks 0-3) those of 4; puts ``(rank,
    "ok", rows by run and the kernels' launches)`` or its traceback on ``out``."""
    import traceback

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks meet on the loopback device
    try:
        import torch
        import torch.distributed as dist

        from pytorch_models_tpu_torch.parallel import (PPDecoderGenerator, TPContinuousBatchingGenerator,
                                                       TPDecoderGenerator, TPPPDecoderGenerator,
                                                       TPSpeculativeGenerator, make_mesh)

        device = "cpu" if cpu else "cuda"
        if cpu:
            torch.set_num_threads(1)  # eight ranks share the host's cores
        else:
            torch.cuda.set_device(0)
        model, draft = _moved(model, device), _moved(draft, device)
        got = {}
        dist.init_process_group("gloo", init_method=f"file://{init_dir}/world8", rank=rank, world_size=WORLD)
        mesh = make_mesh(8, (2, 4), ("dp", "tp"), device=device)
        got["dp x tp"] = TPDecoderGenerator(model, Tok(), mesh).generate_tokens_batch(PROMPTS, max_tokens=8)
        mesh = make_mesh(8, (2, 2, 2), ("dp", "pp", "tp"), device=device)
        got["dp x pp x tp"] = TPPPDecoderGenerator(model, Tok(), mesh).generate_tokens_batch(PROMPTS, max_tokens=8)
        dist.barrier()
        dist.destroy_process_group()
        if rank < 4:
            dist.init_process_group("gloo", init_method=f"file://{init_dir}/world4", rank=rank, world_size=4)
            mesh = make_mesh(4, (4,), ("pp",), device=device)
            got["pp"] = PPDecoderGenerator(model, Tok(), mesh).generate_tokens_batch(PROMPTS, max_tokens=8)
            tp = make_mesh(4, (4,), ("tp",), device=device)
            got["tp speculative"] = TPSpeculativeGenerator(model, draft, Tok(), tp, k=4).generate_tokens(
                PROMPTS[0], max_tokens=8)
            cb = TPContinuousBatchingGenerator(model, Tok(), tp, batch_size=2, prompt_bucket=16, check_every=4)
            got["tp continuous batch"] = cb.generate_tokens_many(PROMPTS, 8)
            got["tp prefix caching"] = cb.generate_tokens_many(PROMPTS, 8, shared_prefix=SYS_PROMPT)
            got["tp sampled serving"] = cb.generate_tokens_many(PROMPTS, 8, topk=4, temperature=0.9, seed=1)
            solo = TPContinuousBatchingGenerator(model, Tok(), tp, batch_size=1, prompt_bucket=16, check_every=1)
            got["solo sampled"] = solo.generate_tokens_many(PROMPTS, 8, topk=4, temperature=0.9, seed=1)
            dist.barrier()
            dist.destroy_process_group()
        got["launches"] = _launches()
        out.put((rank, "ok", got))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def _run_ranks(cpu: bool, model, draft) -> dict:
    """Spawns the 8 ranks and returns their results by rank; raises if a rank
    raised, died or outlived JOIN_S, after stopping every rank."""
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    got = {}
    with tempfile.TemporaryDirectory(prefix="serve_sharded_") as init_dir:
        procs = [ctx.Process(target=_rank, args=(r, init_dir, cpu, model, draft, out), daemon=True)
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        t_end = time.monotonic() + JOIN_S
        try:
            while len(got) < WORLD:
                if time.monotonic() > t_end:
                    raise RuntimeError(f"ranks {sorted(set(range(WORLD)) - set(got))} not done in {JOIN_S} s")
                try:
                    rank, status, value = out.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} died with exit code {procs[dead[0]].exitcode}") from None
                    continue
                if status != "ok":
                    raise RuntimeError(f"rank {rank} raised:\n{value}")
                got[rank] = value
            for p in procs:
                p.join(max(t_end - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
    return got


def _same(what: str, ranks: dict, key: str, expected) -> None:
    for rank, got in sorted(ranks.items()):
        if key in got and got[key] != expected:
            raise AssertionError(f"{what}: rank {rank} differs from the single device: {got[key]} != {expected}")


def main(argv=None, **models) -> dict:
    """``models``: ``model`` and ``draft``, GPT-2s of serve_sharded.py's
    shape to use in place of the ones built here. Returns the single-device
    rows and every rank's results (``ranks``, each with its kernels'
    ``launches``)."""
    args = setup(__doc__, argv)

    from pytorch_models_tpu_torch.text import DecoderGenerator

    model = models.get("model") or _gpt2(n_layers=4, d_model=256, device=args.device)  # 4 heads
    draft = models.get("draft") or _gpt2(n_layers=2, d_model=256, rng=7, device=args.device)

    ref = DecoderGenerator(model, Tok()).generate_tokens_batch(PROMPTS, max_tokens=8)
    print("single-device reference lens:", [len(r) for r in ref])
    ranks = _run_ranks(args.cpu, _moved(model, "cpu"), _moved(draft, "cpu"))

    _same("dp x tp", ranks, "dp x tp", ref)
    print("dp x tp (2x4):        token-identical")
    _same("pp", ranks, "pp", ref)
    print("pp (4 stages):        token-identical")
    _same("dp x pp x tp", ranks, "dp x pp x tp", ref)
    print("dp x pp x tp (2x2x2): token-identical")
    _same("tp speculative", ranks, "tp speculative", ref[0])
    print("tp speculative:       token-identical")
    single = DecoderGenerator(model, Tok())
    _same("tp continuous batch", ranks, "tp continuous batch",
          [single.generate_tokens(p, max_tokens=8) for p in PROMPTS])
    print("tp continuous batch:  token-identical per request")
    # prefix caching: the system prompt is forwarded once, its KV pasted per slot
    _same("tp prefix caching", ranks, "tp prefix caching",
          [single.generate_tokens(SYS_PROMPT + p, max_tokens=8) for p in PROMPTS])
    print("tp prefix caching:    token-identical per request")
    # schedule-invariant sampling: request r's stream depends only on (seed, r)
    for rank, got in sorted(ranks.items()):
        if "solo sampled" in got and got["tp sampled serving"] != got["solo sampled"]:
            raise AssertionError(f"tp sampled serving: rank {rank}'s pool of 2 and pool of 1 part")
    print("tp sampled serving:   schedule-invariant streams")
    return {"ref": ref, "ranks": ranks}


if __name__ == "__main__":
    main()
