#!/usr/bin/env python3
"""Tile trial of the two LN + qkv products on one NVIDIA GPU (sm_90a).

    python scripts/ln_qkv_tile_trial.py

Builds K3 (``csrc/ln_qkv.cu``) and K12/K13's product (``csrc/ln_qkv_int8.cu``,
``ln_qkv_int8_mm_kernel``) at several tilings of the ``gemm_mma.cuh``
mainloop: a copy of each source whose tile line (block tokens and columns,
depth of a k step, ring stages, warps, blocks per SM) is rewritten, compiled
by nvcc with the port's flags into a library of its own.  Each variant runs
at production shape (55,296 tokens, K = F = 768, q width 256) on the same
inputs as the shipped kernel: K3 against its plain twin (relative L2 ≤
1e-2), the product against the shipped kernel bit for bit.  Prints each
variant's ptxas registers and spills, its mean time over 20 launches after
a warm-up (CUDA events) and its rate, then the card's name and power limit.
A variant that spills or disagrees is marked and not eligible.
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

M, K, F, FQ = 55_296, 768, 768, 256
# (tokens, columns, k depth, stages, warps along tokens, along columns,
# blocks per SM); the first of each list is the shipped tiling
K3_TILES = [(128, 128, 64, 3, 2, 4, 2), (128, 128, 32, 4, 2, 4, 2),
            (128, 128, 64, 4, 2, 4, 2), (128, 64, 64, 3, 4, 2, 2),
            (64, 128, 64, 4, 2, 2, 3), (128, 256, 64, 3, 2, 4, 1)]
MM_TILES = [(128, 128, 128, 3, 2, 4, 2), (128, 128, 64, 3, 2, 4, 2),
            (128, 128, 64, 4, 2, 4, 2), (128, 64, 128, 3, 4, 2, 2),
            (64, 128, 128, 4, 2, 2, 3), (128, 256, 128, 3, 2, 4, 1)]
K3_LINE = re.compile(r"constexpr int TOKENS = \d+, COLS = \d+, BK = \d+, "
                     r"STAGES = \d+;\nconstexpr int WM = \d+, WN = \d+, "
                     r"BLOCKS = \d+;")
MM_LINE = re.compile(r"constexpr int MM_TOKENS = \d+, MM_COLS = \d+, "
                     r"MM_BK = \d+, MM_STAGES = \d+;\nconstexpr int "
                     r"MM_WM = \d+, MM_WN = \d+, MM_BLOCKS = \d+;")


def variant_source(name: str, tile) -> str:
    bm, bn, bk, st, wm, wn, blocks = tile
    src = (_build.CSRC / name).read_text()
    if name == "ln_qkv.cu":
        line, pat = (f"constexpr int TOKENS = {bm}, COLS = {bn}, BK = {bk}, "
                     f"STAGES = {st};\nconstexpr int WM = {wm}, WN = {wn}, "
                     f"BLOCKS = {blocks};"), K3_LINE
    else:
        line, pat = (f"constexpr int MM_TOKENS = {bm}, MM_COLS = {bn}, "
                     f"MM_BK = {bk}, MM_STAGES = {st};\nconstexpr int "
                     f"MM_WM = {wm}, MM_WN = {wn}, MM_BLOCKS = {blocks};"),\
            MM_LINE
    out, n = pat.subn(line, src)
    if n != 1:
        raise RuntimeError(f"{name}: the tile line was not found")
    return out


def build_variant(work: Path, name: str, tile) -> tuple:
    """(library path, ptxas registers, spill bytes) of one variant."""
    tag = f"{Path(name).stem}_{'_'.join(map(str, tile))}"
    cu = work / f"{tag}.cu"
    cu.write_text(variant_source(name, tile))
    lib = work / f"lib{tag}.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-I", str(_build.CSRC), "-o", str(lib), str(cu)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{tag}: nvcc failed\n{res.stderr[-2000:]}")
    kernel = "ln_qkv_kernel" if name == "ln_qkv.cu" else "ln_qkv_int8_mm"
    regs = spills = 0
    entry = False
    for line in res.stderr.splitlines():
        if "Compiling entry function" in line:
            entry = kernel in line
        elif entry and "spill stores" in line:
            spills = sum(map(int, re.findall(r"(\d+) bytes spill", line)))
        elif entry and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("ln_qkv_tile_trial: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    wf, c = fused_proj.qkv_weights(
        torch.rand(K, device=dev) + 0.5,
        torch.randn(K, FQ, generator=g, device=dev) * K ** -0.5,
        torch.randn(K, F - FQ, generator=g, device=dev) * K ** -0.5,
        torch.bfloat16)
    ref3 = fused_proj.ln_qkv_plain(x, mu, inv, wf, c, FQ)
    w8, sc, c8 = fused_proj.int8_qkv_weights(
        torch.rand(K, device=dev) + 0.5,
        torch.randn(K, FQ, generator=g, device=dev),
        torch.randn(K, F - FQ, generator=g, device=dev))
    fk = (F - FQ) // 2
    x8, sx = fused_proj.ln_qkv_int8_x(x, mu)
    w8t = w8.t().contiguous()
    shipped = fused_proj.ln_qkv_int8_mm(x8, sx, mu, inv, w8t, sc, c8, FQ, fk)
    stream = torch.cuda.current_stream().cuda_stream

    with tempfile.TemporaryDirectory(prefix="ln_qkv_trial_") as tmp, \
            concurrent.futures.ThreadPoolExecutor(8) as pool:
        jobs = [(name, t, pool.submit(build_variant, Path(tmp), name, t))
                for name, tiles in (("ln_qkv.cu", K3_TILES),
                                    ("ln_qkv_int8.cu", MM_TILES))
                for t in tiles]
        for name, tile, job in jobs:
            lib, regs, spills = job.result()
            if name == "ln_qkv.cu":
                fn = load(lib, "vit_ln_qkv_fwd")
                out = torch.empty_like(ref3)
                args = [t.data_ptr() for t in (x, mu, inv, wf, c, out)] + [
                    M, K, F, FQ, stream]
                ops, what = 2 * M * K * F, "TFLOP/s"
            else:
                fn = load(lib, "vit_ln_qkv_int8_mm")
                out = [torch.empty_like(t) for t in shipped]
                args = [t.data_ptr() for t in (x8, sx, mu, inv, w8t, sc, c8,
                                               *out)] + [M, K, F, FQ, fk,
                                                         stream]
                ops, what = 2 * M * K * F, "TOP/s"
            if fn(*args) != 0:
                print(f"{name} {tile}: launch refused", flush=True)
                continue
            torch.cuda.synchronize()
            if name == "ln_qkv.cu":
                a, b = out.float(), ref3.float()
                ok = bool((torch.linalg.vector_norm(a - b)
                           / torch.linalg.vector_norm(b)) <= 1e-2)
            else:
                ok = all(torch.equal(a, b) for a, b in zip(out, shipped))
            ms = cuda_ms(lambda: fn(*args))
            mark = "" if ok and spills == 0 else "  NOT ELIGIBLE"
            print(f"{name} tokens {tile[0]} cols {tile[1]} bk {tile[2]} "
                  f"stages {tile[3]} warps {tile[4]}x{tile[5]} blocks/SM "
                  f"{tile[6]}: {regs} registers, spill {spills} bytes, "
                  f"{'agrees' if ok else 'DISAGREES'}; {ms:.4f} ms, "
                  f"{ops / ms / 1e9:.1f} {what}{mark}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
