#!/usr/bin/env python3
"""Time builds of the VQ-assignment kernel side by side on one NVIDIA card.

    python3 tools/vq_kernel_ab.py [--other PATH ...] [--reps 50] [--mma-peak] [--sass]

Builds ``vq_seg_tpu_torch/csrc/vq_assign.cu`` and every ``--other`` source of
the same C interface (an earlier revision, for example, saved with
``git show <commit>:vq_seg_tpu_torch/csrc/vq_assign.cu``) with the package's
nvcc flags, then times one wrapper call of each (``vq_cuda.vq_assign_cuda``:
the ||e||^2 reduction, the kernels and the row gather) at the flagship
serving forward's three VQ shapes, on seeded random inputs, with CUDA
events.  The builds take turns: others, this, this, others, so that a drift
of the card's clock during the run shows as a gap between the two rounds of
one build.  Also prints the rows on which each other build's idx differs
from this source's, and the registers and spills ``-Xptxas=-v`` reports.

With ``--mma-peak`` it also builds ``tools/mma_tf32_peak.cu`` and times
warp-level ``mma.sync.m16n8k8`` TF32 alone, from registers, at 1 to 4
blocks of 256 threads per SM: the ceiling of the instruction the score
kernel issues, against the card's 495 TFLOP/s dense TF32 (data sheet).

With ``--sass`` it disassembles every build with ``cuobjdump -sass`` and,
for each score kernel, counts the instructions from its first to its last
HMMA (the unrolled body of one C chunk) and the HMMAs among them.

Prints one line per build and shape, the card line, and last one JSON
object with every time.  Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (N, C, K) of VectorQuantizer at encoder stages 3, 4, 5: batch 8 at 448x448
SHAPES = ((25088, 512, 512), (6272, 1024, 512), (1568, 2048, 512))
MMA_PEAK_SOURCE = os.path.join(ROOT, "tools", "mma_tf32_peak.cu")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sass_counts(vq_cuda, path: str) -> dict:
    """{kernel: (instructions from the first to the last HMMA, HMMAs)} of
    the library at ``path``."""
    cuobjdump = os.path.join(os.path.dirname(vq_cuda._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    counts = {}
    for func in re.split(r"\n\s*Function : ", out)[1:]:
        ops = [m.group(1) for m in re.finditer(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                                               func)]
        hmma = [i for i, op in enumerate(ops) if op.startswith("HMMA")]
        if hmma:
            counts[func.split("\n")[0].strip()] = (hmma[-1] - hmma[0] + 1, len(hmma))
    return counts


def mma_peak(vq_cuda, card: str) -> list:
    """TFLOP/s of mma.sync.m16n8k8 TF32 from registers at 1-4 blocks of 256
    threads per SM."""
    lib = ctypes.CDLL(vq_cuda.build(MMA_PEAK_SOURCE)["path"])
    lib.mma_tf32_peak_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p]
    lib.mma_tf32_peak_launch.restype = ctypes.c_int
    lib.mma_tf32_peak_chains.argtypes = []
    lib.mma_tf32_peak_chains.restype = ctypes.c_int
    chains = lib.mma_tf32_peak_chains()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    iters, threads, rows = 4096, 256, []
    for per_sm in (1, 2, 3, 4):
        blocks = per_sm * sms

        def launch():
            rc = lib.mma_tf32_peak_launch(out.data_ptr(), blocks, threads, iters, stream)
            if rc != 0:
                raise RuntimeError(f"mma_tf32_peak launch failed: CUDA error {rc}")

        ms = cuda_ms(launch, reps=10, warmup=2)
        flop = blocks * threads // 32 * iters * chains * 2 * 16 * 8 * 8
        tflops = flop / ms * 1e-9
        rows.append({"blocks_per_sm": per_sm, "warps_per_sm": per_sm * threads // 32,
                     "ms": ms, "tflops": tflops})
        print(f"[mma-peak] mma.sync.m16n8k8 TF32 from registers, {per_sm * threads // 32} warps "
              f"per SM: {tflops:.1f} TFLOP/s ({100 * tflops / 495:.1f}% of 495) | {card}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], help="another vq_assign.cu")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--mma-peak", action="store_true", help="also time mma.sync TF32 alone")
    ap.add_argument("--sass", action="store_true", help="also count each build's SASS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("vq_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from vq_seg_tpu_torch.ops import vq_cuda

    card = card_line()
    sources = {"this": vq_cuda.SOURCE}
    sources.update({os.path.relpath(p, ROOT): os.path.abspath(p) for p in args.other})
    libs = {}
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        builds = dict(zip(sources, pool.map(vq_cuda.build, sources.values())))
    for name, info in builds.items():
        libs[name] = vq_cuda.load(info["path"])
        print(f"[build] {name}: {'built' if info['built'] else 'reused'} in "
              f"{info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
        if args.sass:
            for func, (span, hmma) in sass_counts(vq_cuda, info["path"]).items():
                print(f"[sass] {name} {func}: {span} instructions from the first to the "
                      f"last HMMA, {hmma} of them HMMA")

    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = [(torch.randn(n, c, device="cuda", generator=g),
               torch.randn(k, c, device="cuda", generator=g)) for n, c, k in SHAPES]
    others = [name for name in libs if name != "this"]
    order = others + ["this", "this"] + others
    times: dict = {name: [[] for _ in SHAPES] for name in libs}
    for name in order:
        for i, (x, cb) in enumerate(inputs):
            times[name][i].append(cuda_ms(lambda: vq_cuda.vq_assign_cuda(x, cb, lib=libs[name]),
                                          args.reps))
    ref = [vq_cuda.vq_assign_cuda(x, cb, lib=libs["this"])[0] for x, cb in inputs]
    result = {"card": card, "reps": args.reps, "builds": {}}
    if args.mma_peak:
        result["mma_peak"] = mma_peak(vq_cuda, card)
    for name in libs:
        rows = []
        for i, ((n, c, k), (x, cb)) in enumerate(zip(SHAPES, inputs)):
            diff = int((vq_cuda.vq_assign_cuda(x, cb, lib=libs[name])[0] != ref[i]).sum())
            ts = times[name][i]
            rows.append({"n": n, "c": c, "k": k, "ms": ts, "idx_rows_differing": diff})
            print(f"[ab] {name} N={n} C={c} K={k}: "
                  f"{' / '.join(f'{t:.4f}' for t in ts)} ms ({2.0 * n * k * c / min(ts) * 1e-9:.1f} "
                  f"TFLOP/s of 2NKC at the best), idx differs from this source on {diff} rows "
                  f"| {card}")
        result["builds"][name] = rows
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
