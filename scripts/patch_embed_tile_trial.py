#!/usr/bin/env python3
"""Tile trial of the fused patch embedding on one NVIDIA GPU (sm_90a).

    python scripts/patch_embed_tile_trial.py

Builds the patch embedding (``csrc/patch_embed.cu``) at several tilings: a
copy of the source whose tile constants (block tokens, columns, ring stages,
warps, blocks per SM) are rewritten, compiled by nvcc with the port's flags
into a library of its own.  Each variant runs at production shape on the
same inputs as the shipped kernel: batch 4 (video (96, 10, 480, 480) bf16,
p 20, D 768), its tokens against the plain twin (relative L2 ≤ 1e-2), its
μ and Σx² against ``patch_stats_plain`` (relative L2 ≤ 1e-5).  (K14's
tilings and ablations are in ``scripts/gemm_wgmma_trial.py``.)

Prints each variant's ptxas registers and spills (the largest over its
template instances), its mean time over 20 launches after a warm-up (CUDA
events) and its rate, then the card's name and power limit.  A variant
that spills or disagrees is marked and not eligible.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from vit_exp_tpu_torch.ops import _build, patches  # noqa: E402

BT, CPT, S, P, D = 96, 10, 480, 20, 768   # batch 4 of 24 frames
# patch embedding: (PE_TOKENS, PE_WM, PE_WN, PE_COLS, PE_STAGES,
# PE_BLOCKS); the first is the shipped tiling
PE_TILES = [(96, 2, 8, 256, 3, 1), (96, 2, 8, 256, 2, 1),
            (96, 2, 4, 128, 2, 2), (96, 2, 4, 256, 3, 1), (96, 2, 4, 128, 3, 1),
            (192, 4, 4, 128, 2, 1), (192, 4, 4, 128, 4, 1),
            (96, 2, 4, 64, 3, 2), (48, 1, 8, 256, 4, 2)]
PE_NAMES = ("PE_TOKENS", "PE_WM", "PE_WN", "PE_COLS", "PE_STAGES",
            "PE_BLOCKS")
# Ablations of the shipped tiling, for where the time goes: each removes one
# part of the kernel by rewriting its source (their results are wrong by
# design; only their times are read).
ABLATIONS = {
    "patch_embed.cu": {
        "no video staging": [("if (c < row_copies)", "if (c < 0)")],
        "no kc staging": [("C::TB::template load<C::THREADS>(stage + "
                           "TA::ELEMS",
                           "if (n0 < 0) C::TB::template load<C::THREADS>("
                           "stage + TA::ELEMS")],
        "no product mma": [
            ("mma(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);", ""),
            ("mma(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);", "")],
        "no statistics mma": [("if (mt == wq) {", "if (mt == wq + 64) {")],
        "no token stores": [("        if (m >= 0)\n",
                             "        if (m < -1)\n")],
    },
}
KERNEL = {"patch_embed.cu": "patch_embed_kernel"}


def variant_source(name: str, names, tile, edits=()) -> str:
    src = (_build.CSRC / name).read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not one place")
        src = src.replace(old, new)
    for const, value in zip(names, tile):
        src, n = re.subn(rf"\b{const} = \d+", f"{const} = {value}", src,
                         count=1)
        if n != 1:
            raise RuntimeError(f"{name}: {const} was not found")
    return src


def build_variant(work: Path, name: str, names, tile, ablation=None) -> tuple:
    """(library path, ptxas registers, spill bytes) of one variant, the
    largest over the kernel's template instances."""
    tag = f"{Path(name).stem}_{'_'.join(map(str, tile))}"
    if ablation:
        tag += "_" + re.sub(r"\W", "_", ablation)
    cu = work / f"{tag}.cu"
    cu.write_text(variant_source(name, names, tile,
                                 ABLATIONS[name][ablation] if ablation
                                 else ()))
    lib = work / f"lib{tag}.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-I", str(_build.CSRC), "-o", str(lib), str(cu)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{tag}: nvcc failed\n{res.stderr[-2000:]}")
    regs = spills = 0
    entry = False
    for line in res.stderr.splitlines():
        if "Compiling entry function" in line:
            entry = KERNEL[name] in line
        elif entry and "spill stores" in line:
            spills = max(spills, sum(map(int, re.findall(
                r"(\d+) bytes spill", line))))
        elif entry and "Used" in line:
            regs = max(regs, int(re.search(r"Used (\d+) registers",
                                           line).group(1)))
            entry = False
    return lib, regs, spills


def load(lib: Path, fn: str):
    f = getattr(ctypes.CDLL(str(lib)), fn)
    f.argtypes, f.restype = _build.SIGNATURES[fn], ctypes.c_int
    return f


def cuda_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10) -> float:
    """Mean device time of fn's kernels per call over iters calls
    (torch.profiler), without the gaps between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / iters


def rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def main() -> int:
    if not torch.cuda.is_available():
        print("patch_embed_tile_trial: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)

    # the patch embedding's inputs and its plain twin's results
    n = CPT * P * P
    video = torch.randn(BT, CPT, S, S, generator=g, device=dev).to(
        torch.bfloat16)
    kf = torch.randn(n, D, generator=g, device=dev) / n ** 0.5
    kc, csum = kf.t().to(torch.bfloat16).contiguous(), kf.sum(0)
    dvec = 0.1 * torch.randn(D, generator=g, device=dev)
    pe = (video, kc, csum, dvec, P, P, 1e-5)
    ref_tok, ref_mu, ref_sq = patches.patch_embed_plain(*pe)
    pe_ops = 2 * BT * (S // P) ** 2 * n * D

    with tempfile.TemporaryDirectory(prefix="patch_embed_trial_") as tmp, \
            concurrent.futures.ThreadPoolExecutor(8) as pool:
        name, names = "patch_embed.cu", PE_NAMES
        plan = [(t, None) for t in PE_TILES]
        plan += [(PE_TILES[0], ab) for ab in ABLATIONS[name]]
        jobs = [(t, ab, pool.submit(build_variant, Path(tmp), name, names, t,
                                    ab))
                for t, ab in plan]
        for tile, ablation, job in jobs:
            lib, regs, spills = job.result()
            label = ", ".join(f"{k.split('_', 1)[1].lower()} {v}"
                              for k, v in zip(names, tile))
            if ablation:
                label += f" (ablation: {ablation}; its results are not read)"
            fn = load(lib, "vit_patch_embed_fwd")
            outs = [torch.empty(t.shape, device=dev, dtype=t.dtype)
                    for t in (ref_tok, ref_mu, ref_sq)]
            args = [t.data_ptr() for t in (video, kc, csum, dvec, *outs)] + [
                BT, CPT, S, S, P, P, D, 1e-5, stream]
            if fn(*args) != 0:
                print(f"{name} {label}: launch refused", flush=True)
                continue
            torch.cuda.synchronize()
            errs = (rel(outs[0], ref_tok), rel(outs[1], ref_mu),
                    rel(outs[2], ref_sq))
            ok = errs[0] <= 1e-2 and max(errs[1:]) <= 1e-5
            agree = f"rel L2 tokens {errs[0]:.2e}, μ {errs[1]:.2e}, " \
                    f"Σx² {errs[2]:.2e}"
            ms = cuda_ms(lambda: fn(*args))
            dev_ms = device_ms(lambda: fn(*args))
            mark = "" if ok and spills == 0 else "  NOT ELIGIBLE"
            if ablation:
                agree, mark = "", ""
            print(f"{name} {label}: {regs} registers, spill {spills} bytes, "
                  f"{agree}; {ms:.4f} ms, {pe_ops / ms / 1e9:.1f} TFLOP/s "
                  f"(profiler device time {dev_ms:.4f} ms){mark}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
