#!/usr/bin/env python3
"""The product stages on ``csrc/gemm_wgmma.cuh`` on one NVIDIA GPU (sm_90a),
against another checkout's kernels.

    python scripts/gemm_wgmma_trial.py [--parent DIR] [--rates]
        [--stages K3,K13mm]
    python scripts/gemm_wgmma_trial.py --variants [--stages K3,K13mm]

Builds the kernel library of this checkout (``_build.build``) and prints
ptxas's registers, spills and wgmma notes for the product kernels on
``csrc/gemm_wgmma.cuh``: K2's act and out, K8's dh, dy and weight GEMM, K3
(the LN + q/kv projection, bf16), K12/K13's product, K11's act and out and
K14 (int8).  At production shape (55,296 tokens, D 768, 2I 4,096; K3 and
K12/K13 at K = F = 768 with q 256 columns wide, k and v 256 each; K14 at K
256, F 768) it runs each stage against its plain twin (relative L2 ≤ 1e-2
on every output, K11's act also on its partial amaxes; K12/K13's product
and K14 bit for bit) and twice for the same bits, then times it (mean of
20 launches after a warm-up, CUDA events) beside its bound (operations at
989 TFLOP/s bf16 or 1,979 TOP/s int8, or bytes at 3.35 TB/s, the larger)
and one library call on the same products (torch.mm, torch._int_mm for the
int8 stages; a yardstick, never on the path).  Beside K14 it times the
two-kernel alternative on the same library: K12/K13's row pass with μ = 0,
then its product with inv = 1 and zero column sums, which give K14's bits.
--stages takes a comma-separated subset.

--parent DIR: the root of another checkout (a ``git archive`` of the parent
commit, unpacked under ``build/``).  Its ``csrc/`` is built with this
checkout's flags into a library of its own and its stages are called
through the same C entry points on the same inputs; the two are timed in
turns (parent, this, this, parent), and the parent's outputs are held to
the same twins and compared with this checkout's bit for bit.

--rates: bf16 and int8 serving (volumes/s, batch 4, median of 5 warm
``predict_batch`` calls; int8 on the bf16 engine's weights) and the
contrastive train step (steps/s at K1 and at K15, median of 5 warm steps)
of each checkout, each in a process of its
own that imports that checkout's package and ``chip_smoke`` helpers, in
turns (parent, this, this, parent).

--variants: instead, builds each entry of VARIANTS (a copy of a source
with some lines rewritten: another tiling, another store path, an
ablation; or a design that was not shipped, kept in
``scripts/gemm_wgmma_variants/``) into a library of its own and times its
stage on the same inputs, with its relative L2 against the twin and
ptxas's spill bytes.

Prints the card's name and power limit as nvidia-smi gives them, and one
JSON line with every number.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from vit_exp_tpu_torch.ops import _build, fused_proj, geglu_ff  # noqa: E402

M, D, I2 = 55_296, 768, 4_096
F3, FQ, FK = 768, 256, 256   # K3's and K12/K13's columns: q, k, v
STAGE_KERNEL = {"K2h": "geglu_ff_h_kernel", "K2o": "geglu_ff_o_kernel",
                "K8dh": "geglu_bwd_dh_kernel", "K8dy": "geglu_bwd_dy_kernel",
                "K8w": "wgrad_kernel", "K3": "ln_qkv_kernel",
                "K13mm": "ln_qkv_int8_mm_kernel",
                "K11h": "geglu_int8_h_kernel", "K11o": "geglu_int8_o_kernel",
                "K14": "proj_int8_kernel"}
KERNELS = tuple(STAGE_KERNEL.values())
EXACT = ("K13mm", "K14")   # held to the twin bit for bit
KP = 256   # K14's depth: 8 heads × 32
PEAK_BF16, PEAK_INT8, HBM = 989e12, 1979e12, 3.35e12
RTOL = 1e-2


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def build_tree(csrc: Path, out: Path) -> tuple:
    """A library from the .cu files of csrc (this checkout's nvcc flags):
    (path, compiler log)."""
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    cus = sorted(csrc.glob("*.cu"))
    objs = [out / (p.stem + ".o") for p in cus]
    with concurrent.futures.ThreadPoolExecutor(len(cus)) as pool:
        logs = list(pool.map(lambda so: _build._run(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(csrc), "-c", str(so[0]),
             "-o", str(so[1])]), zip(cus, objs)))
    lib = out / "libtree.so"
    logs.append(_build._run([nvcc, "-shared", *_build.NVCC_FLAGS[:2], "-o",
                             str(lib), *map(str, objs)]))
    return lib, "\n".join(logs)


def ptxas_lines(log: str) -> list:
    """The ptxas lines of the product kernels' entries, and every line that
    mentions wgmma."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        if "wgmma" in line.lower() or (
                entry and any(k in entry for k in KERNELS)
                and ("registers" in line or "spill" in line)):
            out.append(f"{entry}: {line.strip()}")
    return out


class Lib:
    """The stages of one library, called through its C entry points on
    PyTorch's current stream."""

    def __init__(self, path: Path):
        self.h = ctypes.CDLL(str(path))

    def call(self, name, *args):
        fn = getattr(self.h, name)
        fn.argtypes, fn.restype = _build.SIGNATURES[name], ctypes.c_int
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")

    def stages(self, t):
        """name → a function that launches the stage into t's buffers."""
        p = {k: v.data_ptr() for k, v in t.items() if torch.is_tensor(v)}
        plans = t["plans"]
        return {
            "K2h": lambda: self.call("vit_geglu_ff_h", p["xn"], p["w1p"],
                                     p["d1"], p["o_act"], M, D, I2),
            "K2o": lambda: self.call("vit_geglu_ff_o", p["act"], p["w2"],
                                     p["o_out"], M, D, I2),
            "K8dh": lambda: self.call("vit_geglu_bwd_dh", p["y"], p["dout"],
                                      p["w1"], p["w2"], p["o_dh"],
                                      p["o_act8"], M, D, I2),
            "K8dy": lambda: self.call("vit_geglu_bwd_dy", p["dh"], p["w1"],
                                      p["o_dy"], M, D, I2),
            "K8w": lambda: [self.call("vit_wgrad", p[a], p[b], p[o], M, P,
                                      Q, P, Q, *plan)
                            for (a, b, o, P, Q), plan in zip(
                                (("y", "dh", "o_dw1", D, I2),
                                 ("act", "dout", "o_dw2", I2 // 2, D)),
                                plans)],
            "K3": lambda: self.call("vit_ln_qkv_fwd", p["x3"], p["mu3"],
                                    p["inv3"], p["wf"], p["c3"], p["o_q3"],
                                    M, D, F3, FQ),
            "K13mm": lambda: self.call("vit_ln_qkv_int8_mm", p["x8"], p["sx"],
                                       p["mu3"], p["inv3"], p["w8t"],
                                       p["sc"], p["c8"], p["o_q"], p["o_k"],
                                       p["o_v"], M, D, F3, FQ, FK),
            "K11h": lambda: self.call("vit_geglu_int8_h", p["y8"], p["sy"],
                                      p["w1t"], p["s1"], p["o_act32"],
                                      p["o_part"], M, D, I2),
            "K11o": lambda: self.call("vit_geglu_int8_o", p["a8"], p["sa"],
                                      p["w2t"], p["s2"], p["o_out8"], M, D,
                                      I2),
            "K14": lambda: self.call("vit_proj_int8_fwd", p["xp"], p["wpt"],
                                     p["sp"], p["o_p"], M, KP, F3),
        }

    def k14_two_kernels(self, t):
        """K14's function as two launches of K12/K13's kernels: the row
        pass with μ = 0 (x − 0 = x), then the product with inv = 1 and zero
        column sums over three 256-column outputs (1·d = d, d + 0·0 = d)."""
        p = {k: v.data_ptr() for k, v in t.items() if torch.is_tensor(v)}
        self.call("vit_ln_qkv_int8_x", p["xp"], p["zeros_m"], p["o_xp8"],
                  p["o_sxp"], M, KP)
        self.call("vit_ln_qkv_int8_mm", p["o_xp8"], p["o_sxp"], p["zeros_m"],
                  p["ones_m"], p["wpt"], p["sp"], p["zeros_f"], p["o_p3q"],
                  p["o_p3k"], p["o_p3v"], M, KP, F3, FQ, FK)


def inputs(device) -> dict:
    g = torch.Generator(device=device).manual_seed(20)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=device) * std).to(bf)

    inner = I2 // 2
    x = randn(M, D)
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    t = dict(xn=geglu_ff.geglu_ff_x_plain(x, mu, inv),
             w1p=randn(D, I2, std=D ** -0.5), d1=randn(I2, std=0.1).float(),
             w2=randn(inner, D, std=inner ** -0.5), y=randn(M, D),
             dout=randn(M, D, std=1e-3), w1=randn(D, I2, std=D ** -0.5))
    t["act"] = geglu_ff.geglu_ff_h_plain(t["xn"], t["w1p"], t["d1"])
    t["dh"] = geglu_ff.geglu_bwd_dh_plain(t["y"], t["dout"], t["w1"],
                                          t["w2"])[0]
    t["plans"] = [geglu_ff.wgrad_plan(M, D, I2),
                  geglu_ff.wgrad_plan(M, inner, D)]
    # K3 and K12/K13: the LN + q/k/v projection's operands as the wrappers
    # hand them over (W' = [γ⊙Wq | Wkv]; int8: x8 of x − μ, Wᵀ)
    x3 = randn(M, D) * 2 + 0.5
    mu3, inv3 = geglu_ff.ln_stats(x3, 1e-5)
    gamma = torch.rand(D, generator=g, device=device) + 0.5
    wq = torch.randn(D, FQ, generator=g, device=device) * D ** -0.5
    wkv = torch.randn(D, F3 - FQ, generator=g, device=device) * D ** -0.5
    wf, c3 = fused_proj.qkv_weights(gamma, wq, wkv, bf)
    w8, sc, c8 = fused_proj.int8_qkv_weights(gamma, wq, wkv)
    x8, sx = fused_proj.ln_qkv_int8_x_plain(x3, mu3)
    t.update(x3=x3, mu3=mu3.contiguous(), inv3=inv3.contiguous(), wf=wf,
             c3=c3, x8=x8, sx=sx, w8t=w8.t().contiguous(), sc=sc, c8=c8)
    # K11's act and out: the operands as geglu_ff_int8 hands them over (W1ᵀ,
    # W2ᵀ), y8 from x, a8 from the twin's act; K14: the attention output
    # (M, 256) against a (256, 768) weight, Wᵀ as the wrapper passes it
    y8, sy = geglu_ff.geglu_ff_int8_y_plain(
        x, mu, inv, torch.rand(D, generator=g, device=device) + 0.5,
        0.1 * torch.randn(D, generator=g, device=device))
    w1q, s1 = geglu_ff.quantize_per_channel(randn(D, I2, std=D ** -0.5))
    w2q, s2 = geglu_ff.quantize_per_channel(randn(inner, D,
                                                  std=inner ** -0.5))
    w1t, s1, w2t = geglu_ff.k11_weights(w1q, s1, w2q)
    a8, sa = geglu_ff.geglu_ff_int8_q_plain(
        *geglu_ff.geglu_ff_int8_h_plain(y8, sy, w1t, s1))
    wp8, sp = geglu_ff.quantize_per_channel(randn(KP, F3, std=KP ** -0.5))
    t.update(y8=y8, sy=sy, w1t=w1t, s1=s1, a8=a8, sa=sa, w2t=w2t, s2=s2,
             xp=randn(M, KP, std=0.3), wp8=wp8, wpt=wp8.t().contiguous(),
             sp=sp, zeros_m=torch.zeros(M, 1, device=device),
             ones_m=torch.ones(M, 1, device=device),
             zeros_f=torch.zeros(F3, device=device))
    t["xp8"] = geglu_ff.quant_rows(t["xp"])[0]
    empty = torch.empty
    t.update(o_act=empty(M, inner, device=device, dtype=bf),
             o_out=empty(M, D, device=device, dtype=bf),
             o_dh=empty(M, I2, device=device, dtype=bf),
             o_act8=empty(M, inner, device=device, dtype=bf),
             o_dy=empty(M, D, device=device),
             o_dw1=empty(t["plans"][0][0], D, I2, device=device),
             o_dw2=empty(t["plans"][1][0], inner, D, device=device),
             o_q3=empty(M, F3, device=device, dtype=bf),
             o_q=empty(M, FQ, device=device, dtype=bf),
             o_k=empty(M, FK, device=device, dtype=bf),
             o_v=empty(M, F3 - FQ - FK, device=device, dtype=bf),
             o_act32=empty(M, inner, device=device),
             o_part=empty(M, -(-inner // geglu_ff.AMAX_TILE), device=device),
             o_out8=empty(M, D, device=device, dtype=bf),
             o_p=empty(M, F3, device=device, dtype=bf),
             o_xp8=empty(M, KP, device=device, dtype=torch.int8),
             o_sxp=empty(M, 1, device=device),
             o_p3q=empty(M, FQ, device=device, dtype=bf),
             o_p3k=empty(M, FK, device=device, dtype=bf),
             o_p3v=empty(M, F3 - FQ - FK, device=device, dtype=bf))
    return t


def outputs(t, stage):
    return {"K2h": ("o_act",), "K2o": ("o_out",), "K8dh": ("o_dh", "o_act8"),
            "K8dy": ("o_dy",), "K8w": ("o_dw1", "o_dw2"), "K3": ("o_q3",),
            "K13mm": ("o_q", "o_k", "o_v"), "K11h": ("o_act32", "o_part"),
            "K11o": ("o_out8",), "K14": ("o_p",)}[stage]


def twins(t) -> dict:
    """Each stage's plain outputs, in the order of outputs()."""
    f = geglu_ff
    return {
        "K2h": [f.geglu_ff_h_plain(t["xn"], t["w1p"], t["d1"])],
        "K2o": [f.geglu_ff_o_plain(t["act"], t["w2"])],
        "K8dh": list(f.geglu_bwd_dh_plain(t["y"], t["dout"], t["w1"],
                                          t["w2"])),
        "K8dy": [f.geglu_bwd_dy_plain(t["dh"], t["w1"])],
        "K8w": [f.wgrad_partials_plain(t["y"], t["dh"], *t["plans"][0]),
                f.wgrad_partials_plain(t["act"], t["dout"], *t["plans"][1])],
        "K3": [fused_proj.ln_qkv_plain(t["x3"], t["mu3"], t["inv3"], t["wf"],
                                       t["c3"], FQ)],
        "K13mm": list(fused_proj.ln_qkv_int8_mm_plain(
            t["x8"], t["sx"], t["mu3"], t["inv3"], t["w8t"], t["sc"],
            t["c8"], FQ, FK)),
        "K11h": list(f.geglu_ff_int8_h_plain(t["y8"], t["sy"], t["w1t"],
                                             t["s1"])),
        "K11o": [f.geglu_ff_int8_o_plain(t["a8"], t["sa"], t["w2t"],
                                         t["s2"])],
        "K14": [fused_proj.proj_int8_plain(t["xp"], t["wp8"], t["sp"])],
    }


def rel(a, b) -> float:
    a, b = a.float(), b.float()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b)).item()


def cuda_ms(fn, iters=20) -> float:
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bounds(t) -> dict:
    inner = I2 // 2
    # the tensor-core time of each stage's products
    ops = {"K2h": 2 * M * D * I2 / PEAK_BF16, "K2o": 2 * M * inner * D / PEAK_BF16,
           "K8dh": 2 * M * D * 3 * inner / PEAK_BF16,
           "K8dy": 2 * M * I2 * D / PEAK_BF16,
           "K8w": 2 * M * D * 3 * inner / PEAK_BF16,
           "K3": 2 * M * D * F3 / PEAK_BF16,
           "K13mm": 2 * M * D * F3 / PEAK_INT8,
           "K11h": 2 * M * D * I2 / PEAK_INT8,
           "K11o": 2 * M * inner * D / PEAK_INT8,
           "K14": 2 * M * KP * F3 / PEAK_INT8}
    nb = {s: sum(t[k].numel() * t[k].element_size() for k in ks) for s, ks in
          {"K2h": ("xn", "w1p", "d1", "o_act"), "K2o": ("act", "w2", "o_out"),
           "K8dh": ("y", "dout", "w1", "w2", "o_dh", "o_act8"),
           "K8dy": ("dh", "w1", "o_dy"),
           "K8w": ("y", "dh", "act", "dout", "o_dw1", "o_dw2"),
           "K3": ("x3", "mu3", "inv3", "wf", "c3", "o_q3"),
           "K13mm": ("x8", "sx", "mu3", "inv3", "w8t", "sc", "c8", "o_q",
                     "o_k", "o_v"),
           "K11h": ("y8", "sy", "w1t", "s1", "o_act32", "o_part"),
           "K11o": ("a8", "sa", "w2t", "s2", "o_out8"),
           "K14": ("xp", "wpt", "sp", "o_p")}.items()}
    return {s: max(ops[s], nb[s] / HBM) * 1e3 for s in ops}


def library_yardsticks(t, stages) -> dict:
    """One library call on each stage's products, the products only:
    torch.mm (bf16 out), torch._int_mm (int32 out) for the int8 stages."""
    mm = torch.mm
    calls = {
        "K2h": lambda: mm(t["xn"], t["w1p"]),
        "K2o": lambda: mm(t["act"], t["w2"]),
        "K8dh": lambda: (mm(t["dout"], t["w2"].t()), mm(t["y"], t["w1"])),
        "K8dy": lambda: mm(t["dh"], t["w1"].t()),
        "K8w": lambda: (mm(t["y"].t(), t["dh"]), mm(t["act"].t(), t["dout"])),
        "K3": lambda: mm(t["x3"], t["wf"]),
        "K13mm": lambda: torch._int_mm(t["x8"], t["w8t"].t()),
        "K11h": lambda: torch._int_mm(t["y8"], t["w1t"].t()),
        "K11o": lambda: torch._int_mm(t["a8"], t["w2t"].t()),
        "K14": lambda: torch._int_mm(t["xp8"], t["wpt"].t()),
    }
    return {s: cuda_ms(calls[s]) for s in stages}


def stage_errors(t, ref, s) -> list:
    """Each output's relative L2 against the twin; for an exact stage 0 or
    1 (bits equal or not)."""
    if s in EXACT:
        return [float(not torch.equal(t[o], r))
                for o, r in zip(outputs(t, s), ref[s])]
    return [rel(t[o], r) for o, r in zip(outputs(t, s), ref[s])]


def stage_trial(parent: Path | None, stages) -> dict:
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib_path = _build.build()
    log = lib_path.with_suffix(".log").read_text()
    for line in ptxas_lines(log):
        print(f"this tree, ptxas {line}", flush=True)
    libs = {"this": Lib(lib_path)}
    if parent is not None:
        ppath, plog = build_tree(parent / "vit_exp_tpu_torch" / "csrc",
                                 Path(tempfile.mkdtemp(prefix="parent_lib_")))
        for line in ptxas_lines(plog):
            print(f"parent, ptxas {line}", flush=True)
        libs["parent"] = Lib(ppath)
    t = inputs(device)
    ref = {s: r for s, r in twins(t).items() if s in stages}
    res = {"card": card(), "rows": {}}
    order = ["parent", "this", "this", "parent"] if parent else ["this"]
    times = {s: {k: [] for k in libs} for s in ref}
    kept = {}
    for who, lib in libs.items():
        for s, fn in lib.stages(t).items():
            if s not in stages:
                continue
            fn()
            torch.cuda.synchronize()
            first = [t[o].clone() for o in outputs(t, s)]
            fn()
            torch.cuda.synchronize()
            same = all(torch.equal(a, t[o]) for a, o in zip(first,
                                                            outputs(t, s)))
            errs = stage_errors(t, ref, s)
            print(f"{who} {s}: rel L2 against the twin {errs} (≤ {RTOL}; "
                  f"an exact stage: 0 where the bits are the twin's), same "
                  f"bits twice: {same}", flush=True)
            res["rows"].setdefault(s, {})[f"{who}_rel_l2"] = max(errs)
            res["rows"][s][f"{who}_same_bits"] = same
            if who == "this":
                kept[s] = first
            else:
                equal = all(torch.equal(a, t[o]) for a, o in zip(
                    kept[s], outputs(t, s)))
                print(f"{s}: the parent's bits equal this tree's: {equal}",
                      flush=True)
                res["rows"][s]["bits_equal_parent"] = equal
    for who in order:
        for s, fn in libs[who].stages(t).items():
            if s in stages:
                times[s][who].append(cuda_ms(fn))
    lib_ms = library_yardsticks(t, stages)
    bnd = bounds(t)
    if "K14" in ref:
        two = lambda: libs["this"].k14_two_kernels(t)   # noqa: E731
        two()
        torch.cuda.synchronize()
        same = torch.equal(torch.cat([t["o_p3q"], t["o_p3k"], t["o_p3v"]],
                                     dim=1), ref["K14"][0])
        two_ms = cuda_ms(two)
        res["rows"]["K14"].update(two_kernels_ms=two_ms,
                                  two_kernels_bits_of_the_twin=same)
        print(f"K14's two-kernel alternative (the row pass, then K12/K13's "
              f"product): {two_ms:.4f} ms, the twin's bits: {same}",
              flush=True)
    for s in ref:
        row = res["rows"][s]
        row.update({f"{k}_ms": statistics.mean(v) for k, v in times[s].items()},
                   bound_ms=bnd[s], library_ms=lib_ms[s])
        row["share"] = bnd[s] / row["this_ms"]
        print(f"{s}: this {row['this_ms']:.4f} ms"
              + (f", parent {row['parent_ms']:.4f} ms" if parent else "")
              + f", bound {bnd[s]:.4f} ms (share {row['share']:.3f}), "
              f"the library on the products {lib_ms[s]:.4f} ms", flush=True)
    return res


RATES_CODE = r"""
import json, statistics, sys, time, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from vit_exp_tpu_torch.eval.int8_gate import build_engine
from vit_exp_tpu_torch.models.bert import BertConfig
dev = torch.device("cuda")
bert = BertConfig()
eng = build_engine(dev, cs.ARCH, bert, cs.TEXT_LEN)
eng.prepare()
g = torch.Generator(device=dev).manual_seed(1)
vol = torch.randn((cs.BATCH, 1, cs.ARCH["temporal_size"], cs.ARCH["image_size"],
                   cs.ARCH["image_size"]), generator=g, device=dev).to(torch.bfloat16)
def vps(e):
    e.predict_batch(vol)
    ts = []
    for _ in range(5):
        t0 = time.perf_counter(); e.predict_batch(vol); ts.append(time.perf_counter() - t0)
    return cs.BATCH / statistics.median(ts)
out = {"serve_vps": vps(eng)}
eng8 = build_engine(dev, cs.ARCH, bert, cs.TEXT_LEN, int8=True,
                    state_dict=eng.model.state_dict())
eng8.prepare()
out["serve_int8_vps"] = vps(eng8)
del eng, eng8
torch.cuda.empty_cache()
for impl in ("pallas_static", "pallas"):
    model, opt, step = cs.build_trainer(dev, cs.ARCH, bert, attn_impl=impl)
    batch = cs.train_batch(dev, cs.ARCH, bert.vocab_size, cs.BATCH, cs.TEXT_LEN)
    for _ in range(2):
        float(step(batch, 1.0)["loss"])
    ts = []
    for _ in range(5):
        t0 = time.perf_counter(); float(step(batch, 1.0)["loss"]); ts.append(time.perf_counter() - t0)
    out[f"step_sps_{impl}"] = 1.0 / statistics.median(ts)
    del model, opt, step, batch
    torch.cuda.empty_cache()
print("RATES " + json.dumps(out), flush=True)
"""


def rates(parent: Path) -> dict:
    trees = {"parent": parent, "this": ROOT}
    out = {}
    for who in ("parent", "this", "this", "parent"):
        res = subprocess.run([sys.executable, "-c", RATES_CODE,
                              str(trees[who])], cwd=str(trees[who]),
                             capture_output=True, text=True)
        line = [x for x in res.stdout.splitlines() if x.startswith("RATES ")]
        if res.returncode or not line:
            raise RuntimeError(f"{who}: {res.stdout[-2000:]}\n"
                               f"{res.stderr[-4000:]}")
        got = json.loads(line[0][6:])
        print(f"{who}: {got}", flush=True)
        for k, v in got.items():
            out.setdefault(k, {}).setdefault(who, []).append(v)
    return out


# Variants of one source (a copy rewritten line by line, built alone into a
# library of its own) and the stage each one times: (label, source,
# {shipped text: variant text}, stage); a source is a file of csrc/, or a
# path from the root.  Ablations drop work, so only their time is read.
K2O_STAGED = """#pragma unroll
        for (int part = 0; part < 2; ++part) {
            out.acquire();"""
K2O_DIRECT = """#pragma unroll
        for (int j = 0; j < OGemm::N / 8; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = m0 + wg_row(2 * half);
                const int col = n0 + wg_col(j, 0);
                if (row < M && col < D)
                    store_bf16x2(out_ptr + (size_t)row * D + col,
                                 acc[j][2 * half], acc[j][2 * half + 1]);
            }
        for (int part = 0; part < 0; ++part) {
            out.acquire();"""
K13_EPILOGUE = """        auto pair = [&](int a0, int a1, int half, int col, float2 s2,
                        float2 c2) {
            const float s = half ? rs[1] : rs[0], m = half ? rm[1] : rm[0];
            const float iv = half ? ri[1] : ri[0];
            const float d0 = __fmul_rn(__fmul_rn((float)a0, s), s2.x);
            const float d1 = __fmul_rn(__fmul_rn((float)a1, s), s2.y);
            return make_float2(
                col < Fq ? __fmul_rn(iv, d0) : __fadd_rn(d0, __fmul_rn(m, c2.x)),
                col + 1 < Fq ? __fmul_rn(iv, d1)
                             : __fadd_rn(d1, __fmul_rn(m, c2.y)));
        };"""
K13_CONVERT_ONLY = """        auto pair = [&](int a0, int a1, int half, int col, float2 s2,
                        float2 c2) {
            return make_float2((float)a0, (float)a1);
        };"""
K11H_DESIGNS = "scripts/gemm_wgmma_variants/k11_act_designs.cu"
K11H_TILE_GELU = """                __fadd_rn(1.f, erff(__fmul_rn(g, 0.70710678118654752f))));
            act[j][e] = __fmul_rn(gelu, val);"""
K11H_STAGED = """                for (int half = 0; half < 2; ++half)
                    out.put(col >> 5, wg_row(2 * half), col & 31,
                            make_float2(act[jj][2 * half],
                                        act[jj][2 * half + 1]));"""
K11H_DIRECT = """                for (int half = 0; half < 2; ++half) {
                    const int row = m0 + wg_row(2 * half);
                    const int c = n0 + part * H_PART + col;
                    if (row < M && c < inner)
                        *reinterpret_cast<float2*>(
                            act_ptr + (size_t)row * inner + c) =
                            make_float2(act[jj][2 * half],
                                        act[jj][2 * half + 1]);
                }"""
K14_CODES = """                    if (c >= K) continue;
                    const bf16* xs = reinterpret_cast<const bf16*>(&raw[b][c8]);
                    float y[8];"""
K14_CONSUME = """            consume<PjGemm>(ring, acc, 0, K, codes, PJ_ROWS * STEP_BYTES);"""
K14_START = """    if (cw == 1 && cw < n)
        asm volatile("bar.sync 3, %0;\\n" ::"n"(2 * WG_THREADS) : "memory");"""
K14_HANDOFF = """        if (cw == 0 && i == 0 && n > 1)
            asm volatile("bar.arrive 3, %0;\\n" ::"n"(2 * WG_THREADS)
                         : "memory");"""
VARIANTS = [
    ("K2o shipped", "geglu_ff.cu", {}, "K2o"),
    ("K2o 3 stages", "geglu_ff.cu",
     {"O_COLS = 256, O_STAGES = 4": "O_COLS = 256, O_STAGES = 3"}, "K2o"),
    ("K2o stores from the registers", "geglu_ff.cu",
     {K2O_STAGED: K2O_DIRECT,
      "const __grid_constant__ CUtensorMap out_map, int M, int D,":
      "const __grid_constant__ CUtensorMap out_map, bf16* out_ptr, int M, "
      "int D,",
      "act_map, w2_map, out_map, M, D, inner);":
      "act_map, w2_map, out_map, (bf16*)out, M, D, inner);"}, "K2o"),
    ("K2h shipped", "geglu_ff.cu", {}, "K2h"),
    ("K2h 3 stages", "geglu_ff.cu",
     {"H_COLS = 128, H_STAGES = 4": "H_COLS = 128, H_STAGES = 3"}, "K2h"),
    ("K2h ablation: act = gate·val, no erf", "geglu_ff.cu",
     {"bf16_round(gelu_erf(g.x)) * val.x": "g.x * val.x",
      "bf16_round(gelu_erf(g.y)) * val.y": "g.y * val.y"}, "K2h"),
    ("K8dh shipped", "geglu_ff_bwd.cu", {}, "K8dh"),
    ("K8dh 128 columns, 3 stages", "geglu_ff_bwd.cu",
     {"DH_COLS = 64, DH_STAGES = 6": "DH_COLS = 128, DH_STAGES = 3"}, "K8dh"),
    ("K8dh ablation: no dact mainloop", "geglu_ff_bwd.cu",
     {"produce<DactGemm>(ring, &dout_map, m0, w2t, n1, 0, D);": "",
      "consume<DactGemm>(ring, da, 0, D);": ""}, "K8dh"),
    ("K8dy shipped", "geglu_ff_bwd.cu", {}, "K8dy"),
    ("K8w shipped", "geglu_ff_bwd.cu", {}, "K8w"),
    ("K8w 128 columns, 6 stages", "geglu_ff_bwd.cu",
     {"WG_Q = 256, WG_STAGES = 4": "WG_Q = 128, WG_STAGES = 6"}, "K8w"),
    ("K3 shipped", "ln_qkv.cu", {}, "K3"),
    ("K3 3 stages", "ln_qkv.cu",
     {"COLS = 256, STAGES = 4, PART = 128":
      "COLS = 256, STAGES = 3, PART = 128"}, "K3"),
    ("K3 3 stages, 256 columns staged at once", "ln_qkv.cu",
     {"COLS = 256, STAGES = 4, PART = 128":
      "COLS = 256, STAGES = 3, PART = 256"}, "K3"),
    ("K3 128 columns, 6 stages", "ln_qkv.cu",
     {"COLS = 256, STAGES = 4, PART = 128":
      "COLS = 128, STAGES = 6, PART = 128"}, "K3"),
    ("K3 stores from the registers", "ln_qkv.cu",
     {"out.acquire();": "",
      "out.put(cl >> 6, wg_row(2 * half), cl & 63, y[j][half]);":
      """if (m0 + wg_row(2 * half) < M && n0 + part * PART + cl < F)
                        *reinterpret_cast<uint32_t*>(
                            out_ptr + (size_t)(m0 + wg_row(2 * half)) * F +
                            n0 + part * PART + cl) = y[j][half];""",
      "out.release(maps, cols, m0);": "",
      "const float* __restrict__ c, int M, int K, int F, int Fq) {":
      "const float* __restrict__ c, bf16* out_ptr, int M, int K, int F, "
      "int Fq) {",
      "(const float*)c, M, K, F, Fq);": "(const float*)c, (bf16*)out, M, K, "
      "F, Fq);"}, "K3"),
    ("K3 ablation: no stores (the staging filled, no TMA store)",
     "ln_qkv.cu", {"out.release(maps, cols, m0);": ""}, "K3"),
    ("K13mm shipped", "ln_qkv_int8.cu", {}, "K13mm"),
    ("K13mm 128 columns, 5 stages", "ln_qkv_int8.cu",
     {"MM_COLS = 128, MM_STAGES = 6, MM_PART = 128":
      "MM_COLS = 128, MM_STAGES = 5, MM_PART = 128"}, "K13mm"),
    ("K13mm 64 columns, 8 stages", "ln_qkv_int8.cu",
     {"MM_COLS = 128, MM_STAGES = 6, MM_PART = 128":
      "MM_COLS = 64, MM_STAGES = 8, MM_PART = 64"}, "K13mm"),
    ("K13mm 256 columns, 4 stages", "ln_qkv_int8.cu",
     {"MM_COLS = 128, MM_STAGES = 6, MM_PART = 128":
      "MM_COLS = 256, MM_STAGES = 4, MM_PART = 128"}, "K13mm"),
    ("K13mm 256 columns, 3 stages, 256 columns staged at once",
     "ln_qkv_int8.cu",
     {"MM_COLS = 128, MM_STAGES = 6, MM_PART = 128":
      "MM_COLS = 256, MM_STAGES = 3, MM_PART = 256"}, "K13mm"),
    ("K13mm stores from the registers", "ln_qkv_int8.cu",
     {"if (tile_by_tma(n0, F, Fq, Fk, maps)) {": "if (false) {"}, "K13mm"),
    ("K13mm ablation: no dequantization (the int32 sums converted only)",
     "ln_qkv_int8.cu", {K13_EPILOGUE: K13_CONVERT_ONLY}, "K13mm"),
    ("K13mm ablation: no stores (the staging filled, no TMA store)",
     "ln_qkv_int8.cu", {"out.release(maps2, cols, m0);": ""}, "K13mm"),
    ("K11h shipped", "geglu_ff_int8.cu", {}, "K11h"),
    ("K11h 4 stages, 64 columns staged at a time", "geglu_ff_int8.cu",
     {"H_COLS = 128, H_STAGES = 3, H_PART = 128":
      "H_COLS = 128, H_STAGES = 4, H_PART = 64"}, "K11h"),
    ("K11h 64 columns (val | gate as N 128), 6 stages", "geglu_ff_int8.cu",
     {"H_COLS = 128, H_STAGES = 3, H_PART = 128":
      "H_COLS = 64, H_STAGES = 6, H_PART = 64"}, "K11h"),
    ("K11h stores from the registers", "geglu_ff_int8.cu",
     {K11H_STAGED: K11H_DIRECT, "out.release(maps, cols, m0);": "",
      "float* __restrict__ amax_part, int M, int D, int inner) {":
      "float* __restrict__ amax_part, float* act_ptr, int M, int D, "
      "int inner) {",
      "(const float*)s1, (float*)amax_part, M, D, inner);":
      "(const float*)s1, (float*)amax_part, (float*)act, M, D, inner);"},
     "K11h"),
    ("K11h ping-pong: 128 × (64 | 64) tiles, one consumer each, 3 stages "
     "a ring", K11H_DESIGNS, {}, "K11h"),
    ("K11h ping-pong ablation: act = gelu without erf", K11H_DESIGNS,
     {K11H_TILE_GELU: K11H_TILE_GELU.replace("erff(", "(")}, "K11h"),
    ("K11h overlapped: 128 × (64 | 64), the epilogue between the next "
     "tile's k steps", K11H_DESIGNS,
     {"#define DESIGN 1": "#define DESIGN 2"}, "K11h"),
    ("K11h overlapped ablation: no epilogue math", K11H_DESIGNS,
     {"#define DESIGN 1": "#define DESIGN 2",
      "if (j * ks / HV_G0 != s) continue;": "if (j >= 0) continue;"},
     "K11h"),
    ("K11h ablation: act = gelu without erf", "geglu_ff_int8.cu",
     {"erff(__fmul_rn(g, 0.70710678118654752f))":
      "__fmul_rn(g, 0.70710678118654752f)"}, "K11h"),
    ("K11h ablation: no stores (the staging filled, no TMA store)",
     "geglu_ff_int8.cu", {"out.release(maps, cols, m0);": ""}, "K11h"),
    ("K11h ablation: the mainloop only (no epilogue)", "geglu_ff_int8.cu",
     {"consume<HGemm>(ring, h, 0, D);":
      "consume<HGemm>(ring, h, 0, D);\n        if (D > 0) continue;"},
     "K11h"),
    ("K11o shipped", "geglu_ff_int8.cu", {}, "K11o"),
    ("K11o 3 stages", "geglu_ff_int8.cu",
     {"O_COLS = 256, O_STAGES = 4, O_PART = 128":
      "O_COLS = 256, O_STAGES = 3, O_PART = 128"}, "K11o"),
    ("K11o 128 columns, 6 stages", "geglu_ff_int8.cu",
     {"O_COLS = 256, O_STAGES = 4, O_PART = 128":
      "O_COLS = 128, O_STAGES = 6, O_PART = 128"}, "K11o"),
    ("K11o ablation: no stores (the staging filled, no TMA store)",
     "geglu_ff_int8.cu", {"out.release(outs, cols, m0);": ""}, "K11o"),
    ("K11o ablation: the mainloop only (no epilogue)", "geglu_ff_int8.cu",
     {"consume<OGemm>(ring, acc, 0, inner);":
      "consume<OGemm>(ring, acc, 0, inner);\n        if (D > 0) continue;"},
     "K11o"),
    ("K14 shipped", "ln_qkv_int8.cu", {}, "K14"),
    ("K14 64 columns, 4 stages a ring", "ln_qkv_int8.cu",
     {"PJ_ROWS = 64, PJ_COLS = 128, PJ_STAGES = 2":
      "PJ_ROWS = 64, PJ_COLS = 64, PJ_STAGES = 4"}, "K14"),
    ("K14 the consumers in step (no half-tile offset)", "ln_qkv_int8.cu",
     {K14_START: "", K14_HANDOFF: ""}, "K14"),
    ("K14 ablation: no codes written", "ln_qkv_int8.cu",
     {K14_CODES: K14_CODES.replace("(c >= K)", "(c >= 0)")}, "K14"),
    ("K14 ablation: no stores (the staging filled, no TMA store)",
     "ln_qkv_int8.cu", {"out.release(maps, cols, m0);": ""}, "K14"),
    ("K14 ablation: no epilogue (the codes and the products only)",
     "ln_qkv_int8.cu", {K14_CONSUME: K14_CONSUME + "\n            if (K > 0) "
                        "continue;"}, "K14"),
]


def variant_trial(stages) -> dict:
    """Each of VARIANTS of the given stages built and timed on the same
    inputs (mean of 20 launches after a warm-up), in the list's order."""
    device = torch.device("cuda")
    t = inputs(device)
    ref = twins(t)
    variants = [v for v in VARIANTS if v[3] in stages]
    work = Path(tempfile.mkdtemp(prefix="wgmma_variants_"))

    def build(i, v):
        label, src, subs, _ = v
        text = (ROOT / src if "/" in src else _build.CSRC / src).read_text()
        for a, b in subs.items():
            if text.count(a) != 1:
                raise RuntimeError(f"{label}: {a!r} not found once")
            text = text.replace(a, b)
        cu = work / f"v{i}.cu"
        cu.write_text(text)
        lib = work / f"libv{i}.so"
        log = _build._run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                           "-I", str(_build.CSRC), "-o", str(lib), str(cu)])
        return lib, log

    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda iv: build(*iv), enumerate(variants)))
    out = {}
    for (label, _, _, stage), (lib, log) in zip(variants, built):
        spills = [m.group(2) for m in re.finditer(
            r"entry function '(\w+)'[^\n]*\n(?:[^\n]*\n){0,2}?[^\n]*?"
            r"(\d+) bytes spill stores", log)
            if STAGE_KERNEL[stage].removesuffix("_kernel") in m.group(1)]
        st = Lib(lib).stages(t)[stage]
        st()
        torch.cuda.synchronize()
        errs = stage_errors(t, ref, stage)
        ms = statistics.mean(cuda_ms(st) for _ in range(2))
        out[label] = dict(ms=ms, rel_l2=max(errs),
                          spill_bytes=max(map(int, spills or [0])))
        print(f"variant {label}: {ms:.4f} ms, rel L2 {max(errs):.3e}, "
              f"spill stores {out[label]['spill_bytes']}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--rates", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--stages", default=",".join(STAGE_KERNEL),
                    help="comma-separated stages (default: all)")
    args = ap.parse_args()
    stages = args.stages.split(",")
    if not set(stages) <= set(STAGE_KERNEL):
        ap.error(f"--stages: not among {sorted(STAGE_KERNEL)}: {stages}")
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.variants:
        res = {"card": card(), "variants": variant_trial(stages)}
        print(f"card: {res['card']}", flush=True)
        print(json.dumps(res), flush=True)
        return 0
    res = stage_trial(args.parent, stages)
    bad = [s for s, r in res["rows"].items()
           if r["this_rel_l2"] > (0 if s in EXACT else RTOL)
           or not r["this_same_bits"]]
    if args.rates and args.parent is not None:
        res["rates"] = rates(args.parent.resolve())
    print(f"card: {res['card']}", flush=True)
    print(json.dumps(res), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
