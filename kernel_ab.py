#!/usr/bin/env python3
"""Time K2 (decode attention) and K6 (int8 decode attention) of two source
trees in one process, on one card.

    python3 kernel_ab.py BASE_DIR     # BASE_DIR: a checkout of another commit (git archive)

Builds ``csrc/decode_attention.cu`` and ``csrc/int8_kv.cu`` of this checkout
and of ``BASE_DIR`` (one ``nvcc`` per source, ``sm_90a``), each tree into a
shared library of its own, and times every kernel at ``chip_smoke.py``'s
bf16 shapes through this checkout's wrappers with either library loaded, in
turns base, new, new, base (device time per call, ``chip_smoke._time_ms``).
Both trees must share the C signatures of ``pmt_decode_attention`` and
``pmt_int8_attention``. Prints one line per shape, the card, and a JSON line
of the times in µs. Without a CUDA device it exits with code 2.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke

SOURCES = ("decode_attention.cu", "int8_kv.cu")
ITERS = 50


def build_lib(csrc: Path, out_dir: Path):
    from pytorch_models_tpu_torch.ops import _build as b

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = b._find_nvcc()
    objs, procs = [], []
    for name in SOURCES:
        obj = out_dir / (Path(name).stem + ".o")
        procs.append(subprocess.Popen([nvcc, *b.NVCC_FLAGS, "-c", "-o", str(obj), str(csrc / name)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        objs.append(str(obj))
    for p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed in {csrc}:\n{text[-4000:]}")
    lib_path = out_dir / "libab.so"
    subprocess.run([nvcc, *b.NVCC_FLAGS[:2], "-shared", "-o", str(lib_path), *objs], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("pmt_decode_attention", "pmt_int8_attention"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = b._SIGNATURES[name], ctypes.c_int
    return lib


def _cases(dev):
    """(name, [call per input copy]) at chip_smoke.py's bf16 shapes."""
    import torch

    from pytorch_models_tpu_torch.ops.decode_attention import decode_attention
    from pytorch_models_tpu_torch.ops.int8_kv import int8_decode_attention, quantize_kv_caches

    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    ends, pads = i32([1024, 700, 5, 64, 1, 300, 1000, 512]), i32([0, 10, 5, 0, 0, 299, 3, 100])
    e32 = torch.randint(1, 1025, (32,), generator=g, device=dev, dtype=torch.int32)
    p32 = (torch.rand(32, generator=g, device=dev) * e32).to(torch.int32)
    out = []
    cp = [(rnd(8, 1, 768), rnd(8, 1024, 768), rnd(8, 1024, 768)) for _ in range(4)]
    out.append(("K2 GPT-2 B=8 L=1024", [lambda c=c: decode_attention(*c, ends, 12, pads) for c in cp]))
    cp = [(rnd(8, 1, 512), rnd(8, 1536, 512), rnd(8, 1536, 512)) for _ in range(4)]
    lens = i32([1500] * 8)
    out.append(("K2 Whisper cross B=8 L=1536", [lambda c=c: decode_attention(*c, lens, 8) for c in cp]))
    cp = [(rnd(32, 1, 768), rnd(32, 1024, 768), rnd(32, 1024, 768)) for _ in range(2)]
    out.append(("K2 B=32 L=1024", [lambda c=c: decode_attention(*c, e32, 12, p32) for c in cp]))
    for L, end in ((128, 41), (1024, 1000)):
        cp = [(rnd(8, 1, 768), rnd(8, L, 768), rnd(8, L, 768)) for _ in range(4)]
        bias = 2.0 * rnd(1, L, 12, dtype=torch.float32)
        out.append((f"K2-bias T5 L={L} end={end}",
                    [lambda c=c, b=bias, e=end: decode_attention(*c, e, 12, None, b) for c in cp]))

    def caches(b, lk, hd):
        q = quantize_kv_caches({"k": rnd(b, lk, hd, dtype=torch.float32), "v": rnd(b, lk, hd, dtype=torch.float32)})
        return q["k"], q["v"], q["ks"], q["vs"]

    cp = [(rnd(8, 1, 768), caches(8, 1024, 768)) for _ in range(4)]
    out.append(("K6 GPT-2 B=8 Lk=1024", [lambda c=c: int8_decode_attention(c[0], *c[1], ends, 12, pads) for c in cp]))
    xl = i32([1500, 1500, 7, 1500, 1200, 0, 300, 1500])
    cp = [(rnd(8, 1, 512), caches(8, 1536, 512)) for _ in range(4)]
    out.append(("K6 Whisper cross B=8 Lk=1536", [lambda c=c: int8_decode_attention(c[0], *c[1], xl, 8) for c in cp]))
    for lk, pos in ((128, 41), (1024, 1000)):
        cp = [(rnd(8, 1, 768), caches(8, lk, 768), rnd(8, 768), rnd(8, 768)) for _ in range(4)]
        sb = 2.0 * rnd(lk, 12, dtype=torch.float32)
        out.append((f"K6 T5 Lk={lk} pos={pos} + current + bias",
                    [lambda c=c, p=pos, s=sb: int8_decode_attention(c[0], *c[1], p, 12, None, c[2], c[3], s)
                     for c in cp]))
    return out


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from pytorch_models_tpu_torch.ops import _build

    here = Path(__file__).resolve().parent
    base = Path(sys.argv[1]).resolve()
    libs = {"base": build_lib(base / "pytorch_models_tpu_torch" / "csrc", here / "build" / "ab" / "base"),
            "new": build_lib(_build.CSRC_DIR, here / "build" / "ab" / "new")}
    card = chip_smoke._card()
    dev = torch.device("cuda")
    res = {}
    for name, fns in _cases(dev):
        t = {}
        for turn in ("base", "new", "new", "base"):
            _build._lib = libs[turn]
            t.setdefault(turn, []).append(chip_smoke._time_ms(fns, ITERS) * 1e3)
        res[name] = {k: sum(v) / len(v) for k, v in t.items()}
        print(f"{name}: base {t['base'][0]:.2f} / {t['base'][1]:.2f} us, new {t['new'][0]:.2f} / {t['new'][1]:.2f} "
              f"us [{card}]")
    print(card)
    print(json.dumps({"us": res, "base": str(base)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
