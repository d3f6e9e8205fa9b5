#!/usr/bin/env python3
"""Tile trial of the fused patch embedding and of K14 on one NVIDIA GPU
(sm_90a).

    python scripts/patch_embed_tile_trial.py

Builds the patch embedding (``csrc/patch_embed.cu``) and K14
(``csrc/ln_qkv_int8.cu``, ``proj_int8_kernel``) at several tilings: a copy
of each source whose tile constants (block tokens or rows, columns, k depth,
ring stages, warps, blocks per SM) are rewritten, compiled by nvcc with the
port's flags into a library of its own.  Each variant runs at production
shape on the same inputs as the shipped kernel:

- the patch embedding at batch 4 (video (96, 10, 480, 480) bf16, p 20,
  D 768), its tokens against the plain twin (relative L2 ≤ 1e-2), its μ and
  Σx² against ``patch_stats_plain`` (relative L2 ≤ 1e-5);
- K14 at 55,296 rows, K 256, F 768, against its plain twin bit for bit;
  beside it the baseline that needs no kernel of its own: K12/K13's row
  pass (``ln_qkv_int8_x`` with μ = 0) then its product
  (``ln_qkv_int8_mm`` with inv = 1 and zero column sums), which give K14's
  bits.

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

from vit_exp_tpu_torch.ops import _build, fused_proj, geglu_ff  # noqa: E402
from vit_exp_tpu_torch.ops import patches  # noqa: E402

BT, CPT, S, P, D = 96, 10, 480, 20, 768   # batch 4 of 24 frames
M, K, F = 55_296, 256, 768                 # K14: 8 heads × 32 → 768
# patch embedding: (PE_TOKENS, PE_WM, PE_WN, PE_COLS, PE_STAGES,
# PE_BLOCKS); the first is the shipped tiling
PE_TILES = [(96, 2, 8, 256, 3, 1), (96, 2, 8, 256, 2, 1),
            (96, 2, 4, 128, 2, 2), (96, 2, 4, 256, 3, 1), (96, 2, 4, 128, 3, 1),
            (192, 4, 4, 128, 2, 1), (192, 4, 4, 128, 4, 1),
            (96, 2, 4, 64, 3, 2), (48, 1, 8, 256, 4, 2)]
PE_NAMES = ("PE_TOKENS", "PE_WM", "PE_WN", "PE_COLS", "PE_STAGES",
            "PE_BLOCKS")
# K14: (PJ_ROWS, PJ_COLS, PJ_BK, PJ_STAGES, PJ_WM, PJ_WN, PJ_BLOCKS)
PJ_TILES = [(64, 128, 128, 2, 2, 4, 3), (64, 128, 256, 2, 2, 4, 2),
            (64, 128, 128, 3, 2, 4, 2), (128, 128, 256, 2, 2, 4, 1),
            (64, 256, 256, 2, 2, 4, 1), (32, 128, 256, 2, 1, 4, 4),
            (32, 128, 128, 2, 1, 4, 6)]
PJ_NAMES = ("PJ_ROWS", "PJ_COLS", "PJ_BK", "PJ_STAGES", "PJ_WM", "PJ_WN",
            "PJ_BLOCKS")
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
    "ln_qkv_int8.cu": {
        "no quantization": [("r0 < PJ_ROWS; r0 += NW * RB",
                             "r0 < 0; r0 += NW * RB")],
        "no weight staging": [("        if (s < total) {\n",
                               "        if (s < 0) {\n")],
        "no mma": [
            ("mma_s8(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);", ""),
            ("mma_s8(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);", "")],
        "no stores": [("            if (gr < M)\n",
                       "            if (gr < 0)\n")],
    },
}
KERNEL = {"patch_embed.cu": "patch_embed_kernel",
          "ln_qkv_int8.cu": "proj_int8_kernel"}


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

    # K14's inputs and its twin's bits; the baseline's extra operands
    x = (0.3 * torch.randn(M, K, generator=g, device=dev)).to(torch.bfloat16)
    w8, sc = geglu_ff.quantize_per_channel(
        torch.randn(K, F, generator=g, device=dev) / 16)
    wt = w8.t().contiguous()
    ref14 = fused_proj.proj_int8_plain(x, w8, sc)
    zeros_m = torch.zeros(M, 1, device=dev)
    ones_m, zeros_f = torch.ones(M, 1, device=dev), torch.zeros(F, device=dev)

    with tempfile.TemporaryDirectory(prefix="patch_embed_trial_") as tmp, \
            concurrent.futures.ThreadPoolExecutor(8) as pool:
        plan = [(name, names, t, None)
                for name, names, tiles in (
                    ("patch_embed.cu", PE_NAMES, PE_TILES),
                    ("ln_qkv_int8.cu", PJ_NAMES, PJ_TILES))
                for t in tiles]
        plan += [(name, names, tiles[0], ab)
                 for name, names, tiles in (
                     ("patch_embed.cu", PE_NAMES, PE_TILES),
                     ("ln_qkv_int8.cu", PJ_NAMES, PJ_TILES))
                 for ab in ABLATIONS[name]]
        jobs = [(name, names, t, ab, pool.submit(build_variant, Path(tmp),
                                                 name, names, t, ab))
                for name, names, t, ab in plan]
        baseline = None
        for name, names, tile, ablation, job in jobs:
            lib, regs, spills = job.result()
            label = ", ".join(f"{k.split('_', 1)[1].lower()} {v}"
                              for k, v in zip(names, tile))
            if ablation:
                label += f" (ablation: {ablation}; its results are not read)"
            if name == "patch_embed.cu":
                fn = load(lib, "vit_patch_embed_fwd")
                outs = [torch.empty(t.shape, device=dev, dtype=t.dtype)
                        for t in (ref_tok, ref_mu, ref_sq)]
                args = [t.data_ptr() for t in (video, kc, csum, dvec,
                                               *outs)] + [
                    BT, CPT, S, S, P, P, D, 1e-5, stream]
                ops, what = pe_ops, "TFLOP/s"
            else:
                fn = load(lib, "vit_proj_int8_fwd")
                outs = [torch.empty(ref14.shape, device=dev,
                                    dtype=ref14.dtype)]
                args = [t.data_ptr() for t in (x, wt, sc, outs[0])] + [
                    M, K, F, stream]
                ops, what = 2 * M * K * F, "TOP/s"
            if fn(*args) != 0:
                print(f"{name} {label}: launch refused", flush=True)
                continue
            torch.cuda.synchronize()
            if name == "patch_embed.cu":
                errs = (rel(outs[0], ref_tok), rel(outs[1], ref_mu),
                        rel(outs[2], ref_sq))
                ok = errs[0] <= 1e-2 and max(errs[1:]) <= 1e-5
                agree = f"rel L2 tokens {errs[0]:.2e}, μ {errs[1]:.2e}, " \
                        f"Σx² {errs[2]:.2e}"
            else:
                ok = torch.equal(outs[0], ref14)
                agree = "bit for bit" if ok else "DISAGREES"
            ms = cuda_ms(lambda: fn(*args))
            dev_ms = device_ms(lambda: fn(*args))
            mark = "" if ok and spills == 0 else "  NOT ELIGIBLE"
            if ablation:
                agree, mark = "", ""
            print(f"{name} {label}: {regs} registers, spill {spills} bytes, "
                  f"{agree}; {ms:.4f} ms, {ops / ms / 1e9:.1f} {what} "
                  f"(profiler device time {dev_ms:.4f} ms){mark}", flush=True)
            if name == "ln_qkv_int8.cu" and baseline is None:
                baseline = k14_baseline(x, wt, sc, zeros_m, ones_m, zeros_f,
                                        ref14, stream)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


def k14_baseline(x, wt, sc, zeros_m, ones_m, zeros_f, ref14, stream):
    """K14's function from the shipped K12/K13 kernels: the row pass with
    μ = 0, then the product with inv = 1 and zero column sums over q, k and
    v thirds; prints its time (both launches) and whether it gives K14's
    bits."""
    lib = _build.lib()
    fq = F // 3
    x8 = torch.empty(M, K, device=x.device, dtype=torch.int8)
    sx = torch.empty(M, 1, device=x.device)
    outs = [torch.empty(M, fq, device=x.device, dtype=torch.bfloat16)
            for _ in range(3)]

    def run():
        e1 = lib.vit_ln_qkv_int8_x(*(t.data_ptr() for t in (x, zeros_m, x8,
                                                             sx)), M, K,
                                   stream)
        e2 = lib.vit_ln_qkv_int8_mm(
            *(t.data_ptr() for t in (x8, sx, zeros_m, ones_m, wt, sc,
                                     zeros_f, *outs)), M, K, F, fq, fq,
            stream)
        if e1 or e2:
            raise RuntimeError(f"baseline launch refused: {e1}, {e2}")

    run()
    torch.cuda.synchronize()
    ok = torch.equal(torch.cat(outs, dim=1), ref14)
    x_ms = cuda_ms(lambda: lib.vit_ln_qkv_int8_x(
        *(t.data_ptr() for t in (x, zeros_m, x8, sx)), M, K, stream))
    ms = cuda_ms(run)
    dev_ms = device_ms(run)
    print(f"K14 baseline (profiler device time {dev_ms:.4f} ms) (ln_qkv_int8_x with μ = 0, then ln_qkv_int8_mm "
          f"with inv = 1): {'bit for bit' if ok else 'DISAGREES'} with K14's "
          f"twin; {ms:.4f} ms for both launches (the row pass alone "
          f"{x_ms:.4f} ms)", flush=True)
    return ms


if __name__ == "__main__":
    sys.exit(main())
