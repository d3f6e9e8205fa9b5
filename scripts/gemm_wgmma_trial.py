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
K14 (int8), the attention backward pair of ``csrc/flash_bwd.cu``, the
attention forwards K1/K15 of ``csrc/flash_fwd.cu`` and the patch embedding
of ``csrc/patch_embed.cu`` (their PTX pieces live in ``gemm_wgmma.cuh``).  At production shape (55,296 tokens, D 768, 2I 4,096; K3 and
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
The pair's stages (dKdV32, dQ32, dKdV64, dQ64; a trailing c: over the K15
route's 13,826 keys, 2 nulls concatenated in front, else the static
route's 13,824) run at batch 4, 8 heads, 13,824 queries on heads-last
(b, n, h, d) views, lse from K15 with lse, against the plain backward twin
(relative L2 ≤ 1e-2), with their bound (tensor-core operations, or one exp
per logit at 16 per clock per SM at clocks.max.sm, or bytes) and one SDPA
backward (forward and backward, less the forward) as the yardstick.
The forwards' stages (K1_16 .. K15_64l: the policy, the head dim, a
trailing l with lse) run at the same shape, K1 on strided heads-last q, k
and v with 2 nulls per head (13,824 keys), K15 on the nulls concatenated
in front of contiguous k and v (13,826); K15ring on a 4-shard ring's chunk
(3,456 queries and keys, no nulls, lse) and K15tp4, K15tp2 on a
tensor-parallel rank's 4 and 2 heads (batch 1, 13,826 keys, lse).  Each
is held to its plain twin (relative L2 ≤ 1e-2 on the output, 1e-5 on
lse), with its bound (as the pair's) and one SDPA forward on contiguous
copies (the nulls prepended) as the yardstick.
The patch embedding's stages (``csrc/patch_embed.cu``): PE at production
shape (batch 4: video (96, 10, 480, 480) bf16, p 20, D 768) and PE10 at the
planted path's (batch 32: (384, 10, 120, 120), p 10, D 384), held to
``patch_embed_plain`` (relative L2 ≤ 1e-2 on the tokens, 1e-5 on μ and
Σx²), with their bound (the product's operations, or bytes) and two
yardsticks on the product alone: ``F.conv2d`` on bf16 operands
(library_ms) and ``torch.mm`` over a pre-built patch matrix
(library_mm_ms).
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

from vit_exp_tpu_torch.ops import _build, fused_proj, geglu_ff, patches  # noqa: E402
from vit_exp_tpu_torch.ops import flash_attention as fa  # noqa: E402

M, D, I2 = 55_296, 768, 4_096
F3, FQ, FK = 768, 256, 256   # K3's and K12/K13's columns: q, k, v
STAGE_KERNEL = {"K2h": "geglu_ff_h_kernel", "K2o": "geglu_ff_o_kernel",
                "K8dh": "geglu_bwd_dh_kernel", "K8dy": "geglu_bwd_dy_kernel",
                "K8w": "wgrad_kernel", "K3": "ln_qkv_kernel",
                "K13mm": "ln_qkv_int8_mm_kernel",
                "K11h": "geglu_int8_h_kernel", "K11o": "geglu_int8_o_kernel",
                "K14": "proj_int8_kernel"}
# the backward pair: (kernel, head dim, over the K15 route's nulls)
ATTN_STAGES = {f"{kind}{d}{'c' if cat else ''}": (kind, d, cat)
               for kind in ("dKdV", "dQ") for d in (32, 64)
               for cat in (False, True)}
STAGE_KERNEL.update({s: "flash_bwd_dkv_kernel" if kind == "dKdV"
                     else "flash_bwd_dq_kernel"
                     for s, (kind, _, _) in ATTN_STAGES.items()})
# the forwards: (policy, head dim, with lse, shape); shapes (batch, heads,
# queries, keys before the nulls, nulls): the production layer, a 4-shard
# ring's chunk, a tensor-parallel rank's heads at model 2 and 4
FWD_SHAPES = {"full": (4, 8, 13_824, 13_824, 2), "ring": (4, 8, 3_456, 3_456, 0),
              "tp4": (1, 4, 13_824, 13_824, 2), "tp2": (1, 2, 13_824, 13_824, 2)}
FWD_STAGES = {f"{kind}_{d}{'l' if lse else ''}": (kind, d, lse, "full")
              for kind in ("K1", "K15") for d in (16, 32, 64)
              for lse in (False, True)}
FWD_STAGES.update(K15ring=("K15", 32, True, "ring"),
                  K15tp4=("K15", 32, True, "tp4"),
                  K15tp2=("K15", 32, True, "tp2"))
STAGE_KERNEL.update({s: "flash_fwd_kernel" for s in FWD_STAGES})
# the patch embedding: (BT, CPT, H, W, p1, p2, D); batch 4 of the production
# arch (24 frames a volume) and batch 32 of the planted arch (12)
PE_STAGES = {"PE": (96, 10, 480, 480, 20, 20, 768),
             "PE10": (384, 10, 120, 120, 10, 10, 384)}
STAGE_KERNEL.update({s: "patch_embed_kernel" for s in PE_STAGES})
PE_EPS = 1e-5
STATS_RTOL = 1e-5   # μ and Σx² against the twin
BATCH, HEADS, NQ, N_NULL = 4, 8, 13_824, 2
LSE_RTOL = 1e-5
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
            **{s: self.pair(t, kind, attn_prefix(d, cat))
               for s, (kind, d, cat) in ATTN_STAGES.items()
               if attn_prefix(d, cat) + "q" in t},
            **{s: self.forward(t, s) for s in FWD_STAGES
               if "fo_" + s in t},
            **{s: self.patch_embed(t, s) for s in PE_STAGES
               if pe_prefix(s) + "x" in t},
        }

    def patch_embed(self, t, stage):
        """The patch embedding through its C entry point."""
        pre = pe_prefix(stage)
        ptrs = [t[pre + n].data_ptr() for n in ("x", "kc", "csum", "dvec",
                                                 "tok", "mu", "sq")]
        return lambda: self.call("vit_patch_embed_fwd", *ptrs,
                                 *PE_STAGES[stage], PE_EPS)

    def forward(self, t, stage):
        """K1 or K15 through its C entry point, into the stage's buffers."""
        kind, d, lse, shape = FWD_STAGES[stage]
        pre = fwd_prefix(d, shape)
        out, lse_t = t["fo_" + stage], t.get("fl_" + stage)
        q, scale = t[pre + "q"], t[pre + "scale"]
        b, h, nq, _ = q.shape
        lp = None if lse_t is None else lse_t.data_ptr()
        if kind == "K1":
            k, v, nk, nv = (t[pre + n] for n in ("k", "v", "nk", "nv"))
            strides = [x for y in (q, k, v, out) for x in y.stride()[:3]]
            ptrs = [x.data_ptr() for x in (q, k, v, nk, nv, t[pre + "bound"],
                                           out)]
            return lambda: self.call("vit_flash_static_fwd", *ptrs, lp,
                                     *strides, b, h, nq, k.shape[2],
                                     nk.shape[1], d, scale)
        k, v = t[pre + "kc"], t[pre + "vc"]
        strides = [x for y in (q, k, v, out) for x in y.stride()[:3]]
        ptrs = [x.data_ptr() for x in (q, k, v, out)]
        return lambda: self.call("vit_flash_online_fwd", *ptrs, lp, *strides,
                                 b, h, nq, k.shape[2], d, scale)

    def pair(self, t, kind, pre):
        """One kernel of the backward pair through its C entry point."""
        q, k, v, o = (t[pre + n] for n in ("q", "k", "v", "dout"))
        outs = [t[pre + n] for n in (("dk", "dv") if kind == "dKdV"
                                     else ("dq",))]
        strides = [s for x in (q, k, v, o, *outs) for s in x.stride()[:3]]
        b, h, nq, d = q.shape
        name = "vit_flash_bwd_dkv" if kind == "dKdV" else "vit_flash_bwd_dq"
        ptrs = [x.data_ptr() for x in (q, k, v, o, t[pre + "lse"],
                                       t[pre + "delta"], *outs)]
        return lambda: self.call(name, *ptrs, *strides, b, h, nq, k.shape[2],
                                 d, t[pre + "scale"])

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


def attn_prefix(d, cat) -> str:
    return f"a{d}{'c' if cat else ''}_"


def fwd_prefix(d, shape) -> str:
    return f"f{d}{shape}_"


def pe_prefix(stage) -> str:
    return f"pe{stage}_"


def pe_inputs(device, t, stages) -> None:
    """The patch embedding's operands for each of its stages among stages,
    into t, as fused_patch_embed hands them over: the video (BT, CPT, H, W)
    bf16, kc = (γ⊙W)ᵀ (D, n) bf16, csum and dvec (D,) fp32 from seeded
    LayerNorm and Linear weights; the tokens, μ and Σx² as the wrapper
    allocates them."""
    g = torch.Generator(device=device).manual_seed(25)
    for s in stages:
        if s not in PE_STAGES:
            continue
        bt, cpt, h, w, p1, p2, d = PE_STAGES[s]
        n = cpt * p1 * p2
        gamma = 1 + 0.1 * torch.randn(n, generator=g, device=device)
        beta = 0.1 * torch.randn(n, generator=g, device=device)
        wt = torch.randn(n, d, generator=g, device=device) / n ** 0.5
        kf = wt * gamma[:, None]
        pre = pe_prefix(s)
        t.update({pre + "x": torch.randn(bt, cpt, h, w, generator=g,
                                         device=device).to(torch.bfloat16),
                  pre + "kc": kf.t().to(torch.bfloat16).contiguous(),
                  pre + "csum": kf.sum(0).contiguous(),
                  pre + "dvec": (beta @ wt + 0.1 * torch.randn(
                      d, generator=g, device=device)).contiguous(),
                  pre + "tok": torch.empty(bt, h // p1, w // p2, d,
                                           device=device,
                                           dtype=torch.bfloat16),
                  pre + "mu": torch.empty(bt, h // p1, w // p2,
                                          device=device)})
        t[pre + "sq"] = torch.empty_like(t[pre + "mu"])


def fwd_inputs(device, t, stages) -> None:
    """The forwards' operands for each (head dim, shape) among stages, into
    t: q, k and v as strided heads-last (b, n, h, d) views (k and v of one
    (b, n, 2·h·d) buffer, as the projection leaves them), q and k
    l2-normalised, 2 nulls per head and the bound for K1; k and v with the
    nulls concatenated in front (contiguous) for K15; each stage's output
    (and lse) laid out as the wrappers leave them."""
    g = torch.Generator(device=device).manual_seed(24)
    bf = torch.bfloat16

    def unit(x):
        return x / x.norm(dim=-1, keepdim=True)

    for d, shape in sorted({(FWD_STAGES[s][1], FWD_STAGES[s][3])
                            for s in stages if s in FWD_STAGES}):
        pre = fwd_prefix(d, shape)
        b, h, nq, nkv, n_null = FWD_SHAPES[shape]
        q = unit(torch.randn(b, nq, h, d, generator=g, device=device)).to(bf)
        kv = torch.randn(b, nkv, 2, h, d, generator=g, device=device)
        kv[:, :, 0] = unit(kv[:, :, 0])
        kv = kv.to(bf).reshape(b, nkv, 2 * h * d)
        k = kv[..., :h * d].reshape(b, nkv, h, d).transpose(1, 2)
        v = kv[..., h * d:].reshape(b, nkv, h, d).transpose(1, 2)
        nk = unit(torch.randn(h, max(n_null, 1), d, generator=g,
                              device=device)).to(bf)[:, :n_null].contiguous()
        nv = torch.randn(h, max(n_null, 1), d, generator=g,
                         device=device).to(bf)[:, :n_null].contiguous()
        scale = d ** -0.5
        t.update({pre + "q": q.transpose(1, 2), pre + "k": k, pre + "v": v,
                  pre + "nk": nk, pre + "nv": nv, pre + "scale": scale,
                  pre + "bound": torch.tensor(scale, device=device),
                  pre + "kc": torch.cat([nk[None].expand(b, -1, -1, -1), k],
                                        dim=2),
                  pre + "vc": torch.cat([nv[None].expand(b, -1, -1, -1), v],
                                        dim=2)})
    for s in stages:
        if s not in FWD_STAGES:
            continue
        _, d, lse, shape = FWD_STAGES[s]
        q = t[fwd_prefix(d, shape) + "q"]
        t["fo_" + s] = fa._heads_last_like(q)
        if lse:
            t["fl_" + s] = torch.empty(q.shape[:3], device=device)


def attn_inputs(device, t, stages) -> None:
    """The pair's operands for each (head dim, route) among stages, into t:
    q, k, v and dO as heads-last (b, n, h, d) views (k and v contiguous
    after the nulls' concatenation on the K15 route), lse from K15 with
    lse, δ = rowsum(dO ⊙ O), and the outputs laid out as the wrappers
    leave them."""
    g = torch.Generator(device=device).manual_seed(23)
    bf = torch.bfloat16

    def heads(n, d, std=1.0, unit=False):
        x = torch.randn(BATCH, n, HEADS, d, generator=g, device=device) * std
        if unit:
            x = x / x.norm(dim=-1, keepdim=True)
        return x.to(bf).transpose(1, 2)

    for d, cat in sorted({ATTN_STAGES[s][1:] for s in stages
                          if s in ATTN_STAGES}):
        pre = attn_prefix(d, cat)
        q, k, v = heads(NQ, d, unit=True), heads(NQ, d, unit=True), heads(NQ, d)
        if cat:
            nk = torch.randn(HEADS, N_NULL, d, generator=g, device=device)
            nk = (nk / nk.norm(dim=-1, keepdim=True)).to(bf)
            nv = torch.randn(HEADS, N_NULL, d, generator=g,
                             device=device).to(bf)
            k = torch.cat([nk[None].expand(BATCH, -1, -1, -1), k], dim=2)
            v = torch.cat([nv[None].expand(BATCH, -1, -1, -1), v], dim=2)
        scale = d ** -0.5
        dout = heads(NQ, d, std=1e-3)
        with torch.no_grad():
            out, lse = fa.attention_online(q, k, v, scale, save_lse=True)
        delta = (dout.float() * out.float()).sum(-1)
        t.update({pre + "q": q, pre + "k": k, pre + "v": v,
                  pre + "dout": dout, pre + "lse": lse, pre + "delta": delta,
                  pre + "scale": scale, pre + "dq": fa._heads_last_like(q),
                  pre + "dk": fa._heads_last_like(k),
                  pre + "dv": fa._heads_last_like(v)})


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
    if stage in PE_STAGES:
        return tuple(pe_prefix(stage) + n for n in ("tok", "mu", "sq"))
    if stage in FWD_STAGES:
        return ("fo_" + stage,) + (("fl_" + stage,) if FWD_STAGES[stage][2]
                                   else ())
    if stage in ATTN_STAGES:
        kind, d, cat = ATTN_STAGES[stage]
        pre = attn_prefix(d, cat)
        return (pre + "dk", pre + "dv") if kind == "dKdV" else (pre + "dq",)
    return {"K2h": ("o_act",), "K2o": ("o_out",), "K8dh": ("o_dh", "o_act8"),
            "K8dy": ("o_dy",), "K8w": ("o_dw1", "o_dw2"), "K3": ("o_q3",),
            "K13mm": ("o_q", "o_k", "o_v"), "K11h": ("o_act32", "o_part"),
            "K11o": ("o_out8",), "K14": ("o_p",)}[stage]


def twins(t, stages) -> dict:
    """Each of stages' plain outputs, in the order of outputs()."""
    f = geglu_ff
    pairs = {}

    def pair(stage):
        kind, d, cat = ATTN_STAGES[stage]
        pre = attn_prefix(d, cat)
        if pre not in pairs:
            pairs[pre] = fa.attention_bwd_plain(*(t[pre + n] for n in (
                "q", "k", "v", "dout", "lse", "delta", "scale")))
        dq, dk, dv = pairs[pre]
        return [dk, dv] if kind == "dKdV" else [dq]

    calls = {
        "K2h": lambda: [f.geglu_ff_h_plain(t["xn"], t["w1p"], t["d1"])],
        "K2o": lambda: [f.geglu_ff_o_plain(t["act"], t["w2"])],
        "K8dh": lambda: list(f.geglu_bwd_dh_plain(t["y"], t["dout"],
                                                  t["w1"], t["w2"])),
        "K8dy": lambda: [f.geglu_bwd_dy_plain(t["dh"], t["w1"])],
        "K8w": lambda: [
            f.wgrad_partials_plain(t["y"], t["dh"], *t["plans"][0]),
            f.wgrad_partials_plain(t["act"], t["dout"], *t["plans"][1])],
        "K3": lambda: [fused_proj.ln_qkv_plain(t["x3"], t["mu3"], t["inv3"],
                                               t["wf"], t["c3"], FQ)],
        "K13mm": lambda: list(fused_proj.ln_qkv_int8_mm_plain(
            t["x8"], t["sx"], t["mu3"], t["inv3"], t["w8t"], t["sc"],
            t["c8"], FQ, FK)),
        "K11h": lambda: list(f.geglu_ff_int8_h_plain(t["y8"], t["sy"],
                                                     t["w1t"], t["s1"])),
        "K11o": lambda: [f.geglu_ff_int8_o_plain(t["a8"], t["sa"], t["w2t"],
                                                 t["s2"])],
        "K14": lambda: [fused_proj.proj_int8_plain(t["xp"], t["wp8"],
                                                   t["sp"])],
    }
    def forward(stage):
        kind, d, lse, shape = FWD_STAGES[stage]
        pre = fwd_prefix(d, shape)
        q, scale = t[pre + "q"], t[pre + "scale"]
        if kind == "K1":
            r = fa.attention_static_plain(q, *(t[pre + n] for n in (
                "k", "v", "nk", "nv", "bound")), scale, save_lse=lse)
        else:
            r = fa.attention_online_plain(q, t[pre + "kc"], t[pre + "vc"],
                                          scale, save_lse=lse)
        return list(r) if lse else [r]

    def patch_embed(stage):
        pre = pe_prefix(stage)
        _, _, _, _, p1, p2, _ = PE_STAGES[stage]
        return list(patches.patch_embed_plain(
            *(t[pre + n] for n in ("x", "kc", "csum", "dvec")), p1, p2,
            PE_EPS))

    return {s: pair(s) if s in ATTN_STAGES else forward(s)
            if s in FWD_STAGES else patch_embed(s) if s in PE_STAGES
            else calls[s]() for s in stages}


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


def exp_rate() -> float:
    """Exps a second on the special-function unit: 16 per clock per SM at
    the SM clock nvidia-smi reports as clocks.max.sm."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 16 * sms * mhz * 1e6


def attn_bounds(t, stages) -> dict:
    """The pair's stages: the largest of its products at the bf16 peak, one
    exp a logit, and its bytes (each input read once, each output written
    once)."""
    out, rate = {}, None
    for s in stages:
        if s not in ATTN_STAGES:
            continue
        rate = rate or exp_rate()
        kind, d, cat = ATTN_STAGES[s]
        pre = attn_prefix(d, cat)
        q, k = t[pre + "q"], t[pre + "k"]
        logits = q.shape[0] * q.shape[1] * q.shape[2] * k.shape[2]
        products = 4 if kind == "dKdV" else 3
        nb = sum(t[n].numel() * t[n].element_size()
                 for n in [pre + n for n in ("q", "k", "v", "dout", "lse",
                                             "delta")] + list(outputs(t, s)))
        out[s] = max(products * 2 * logits * d / PEAK_BF16, logits / rate,
                     nb / HBM) * 1e3
    return out


def fwd_bounds(t, stages) -> dict:
    """The forwards' stages: the largest of their two products at the bf16
    peak, one exp a logit, and their bytes (each input read once, each
    output written once)."""
    out, rate = {}, None
    for s in stages:
        if s not in FWD_STAGES:
            continue
        rate = rate or exp_rate()
        kind, d, _, shape = FWD_STAGES[s]
        pre = fwd_prefix(d, shape)
        q = t[pre + "q"]
        names = ("k", "v", "nk", "nv") if kind == "K1" else ("kc", "vc")
        nkv = t[pre + "kc"].shape[2]   # the nulls included
        logits = q.shape[0] * q.shape[1] * q.shape[2] * nkv
        nb = sum(t[n].numel() * t[n].element_size()
                 for n in [pre + "q"] + [pre + n for n in names]
                 + list(outputs(t, s)))
        out[s] = max(2 * 2 * logits * d / PEAK_BF16, logits / rate,
                     nb / HBM) * 1e3
    return out


def pe_bounds(t, stages) -> dict:
    """The patch embedding's stages: the larger of the product's operations
    at the bf16 peak and its bytes (each input read once, each output
    written once)."""
    out = {}
    for s in stages:
        if s not in PE_STAGES:
            continue
        bt, cpt, h, w, p1, p2, d = PE_STAGES[s]
        m, n = bt * (h // p1) * (w // p2), cpt * p1 * p2
        pre = pe_prefix(s)
        nb = sum(t[pre + k].numel() * t[pre + k].element_size() for k in (
            "x", "kc", "csum", "dvec", "tok", "mu", "sq"))
        out[s] = max(2 * m * n * d / PEAK_BF16, nb / HBM) * 1e3
    return out


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
    sdpa = {}

    def sdpa_backward(stage):
        """One SDPA backward on contiguous copies of the stage's q, k, v
        and dO: forward and backward, less the forward."""
        pre = attn_prefix(*ATTN_STAGES[stage][1:])
        if pre not in sdpa:
            qc, kc, vc = (t[pre + n].contiguous().requires_grad_()
                          for n in ("q", "k", "v"))
            g, scale = t[pre + "dout"].contiguous(), t[pre + "scale"]

            def fwd():
                return torch.nn.functional.scaled_dot_product_attention(
                    qc, kc, vc, scale=scale)

            with torch.no_grad():
                t_fwd = cuda_ms(fwd)
            sdpa[pre] = cuda_ms(lambda: torch.autograd.grad(
                fwd(), (qc, kc, vc), g)) - t_fwd
        return sdpa[pre]

    def sdpa_forward(stage):
        """One SDPA forward on contiguous copies of the stage's q and k, v
        with the nulls in front."""
        _, d, _, shape = FWD_STAGES[stage]
        pre = fwd_prefix(d, shape)
        if pre + "sdpa" not in sdpa:
            qc, kc, vc = (t[pre + n].contiguous() for n in ("q", "kc", "vc"))
            with torch.no_grad():
                sdpa[pre + "sdpa"] = cuda_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qc, kc, vc, scale=t[pre + "scale"]))
        return sdpa[pre + "sdpa"]

    def conv(stage):
        """F.conv2d on the stage's bf16 video and kc: the strided product
        alone."""
        bt, cpt, h, w, p1, p2, d = PE_STAGES[stage]
        pre = pe_prefix(stage)
        kc4 = t[pre + "kc"].reshape(d, cpt, p1, p2)
        return cuda_ms(lambda: torch.nn.functional.conv2d(
            t[pre + "x"], kc4, stride=(p1, p2)))

    return {s: sdpa_backward(s) if s in ATTN_STAGES else sdpa_forward(s)
            if s in FWD_STAGES else conv(s) if s in PE_STAGES
            else cuda_ms(calls[s]) for s in stages}


def pe_mm_yardsticks(t, stages) -> dict:
    """torch.mm of each patch-embedding stage's video as a pre-built
    (tokens, n) patch matrix (built once, outside the timing; feature order
    (c, p1, p2)) and kcᵀ: the product alone."""
    out = {}
    for s in stages:
        if s in PE_STAGES:
            bt, cpt, h, w, p1, p2, _ = PE_STAGES[s]
            pre = pe_prefix(s)
            a = t[pre + "x"].reshape(bt, cpt, h // p1, p1, w // p2,
                                     p2).permute(0, 2, 4, 1, 3, 5).reshape(
                -1, cpt * p1 * p2)
            b = t[pre + "kc"].t()
            out[s] = cuda_ms(lambda: torch.mm(a, b))
            del a
    return out


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
    attn_inputs(device, t, stages)
    fwd_inputs(device, t, stages)
    pe_inputs(device, t, stages)
    ref = twins(t, stages)
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
            res["rows"].setdefault(s, {})[f"{who}_rel_l2"] = errs[0] if (
                s in FWD_STAGES or s in PE_STAGES) else max(errs)
            if s in FWD_STAGES and FWD_STAGES[s][2]:
                res["rows"][s][f"{who}_lse_rel"] = errs[1]
            if s in PE_STAGES:
                res["rows"][s][f"{who}_stats_rel"] = max(errs[1:])
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
    mm_ms = pe_mm_yardsticks(t, stages)
    bnd = {**bounds(t), **attn_bounds(t, stages), **fwd_bounds(t, stages),
           **pe_bounds(t, stages)}
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
        if s in mm_ms:
            row["library_mm_ms"] = mm_ms[s]
        print(f"{s}: this {row['this_ms']:.4f} ms"
              + (f", parent {row['parent_ms']:.4f} ms" if parent else "")
              + f", bound {bnd[s]:.4f} ms (share {row['share']:.3f}), "
              + ("one SDPA backward" if s in ATTN_STAGES
                 else "one SDPA forward" if s in FWD_STAGES
                 else "F.conv2d on bf16" if s in PE_STAGES
                 else "the library on the products")
              + f" {lib_ms[s]:.4f} ms"
              + (f", torch.mm over a pre-built patch matrix "
                 f"{mm_ms[s]:.4f} ms" if s in mm_ms else ""), flush=True)
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
BWD_DS = "s[j][e] * fmaf(dp[j][e], scale, e & 1 ? nd.y : nd.x)"
BWD_IN_STEP = "scripts/gemm_wgmma_variants/flash_bwd_in_step.cu"
# S and dP with their A operand (K, V; Q, dO) read from shared memory
BWD_SS = {
    """                                             const uint32_t (&a)[D / 16][4],
                                             uint32_t b) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
        WgmmaRS<BT, 0>::run(s, a[kk], Tile<D>::rows(b, kk), kk > 0);""":
    """                                             uint32_t a, uint32_t b) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BT, 0, 0>::run(s, Tile<D>::rows(a, kk), Tile<D>::rows(b, kk),
                             kk > 0);""",
    """        rows_product<D>(s, ka, qt);
        rows_product<D>(dp, va, qt + T::BYTES);""":
    """        rows_product<D>(s, kc, qt);
        rows_product<D>(dp, vc, qt + T::BYTES);""",
    """        rows_product<D>(s, qa, kt);
        rows_product<D>(dp, oa, kt + T::BYTES);""":
    """        rows_product<D>(s, qc, kt);
        rows_product<D>(dp, oc, kt + T::BYTES);""",
    """    load_rows<D>(ka, kc);
    load_rows<D>(va, vc);""": "",
    """    load_rows<D>(qa, qc);
    load_rows<D>(oa, oc);""": ""}
BWD_EXP = "s[j][e] = exp2_approx(fmaf(s[j][e], c2, e & 1 ? nl.y : nl.x));"
BWD_EXP_OFF = "s[j][e] = fmaf(s[j][e], c2, e & 1 ? nl.y : nl.x);"
BWD_PACK_LOP = {f"a[i][{k}] = pack_bf16(x[{r}][{e}], x[{r}][{e + 1}]);":
                f"a[i][{k}] = __float_as_uint(x[{r}][{e}]) ^ "
                f"__float_as_uint(x[{r}][{e + 1}]);"
                for k, r, e in ((0, "2 * i", 0), (1, "2 * i", 2),
                                (2, "2 * i + 1", 0), (3, "2 * i + 1", 2))}
BWD_LOGITS = """    auto logits = [&](uint32_t qt) {
        rows_product<D>(s, ka, qt);
        rows_product<D>(dp, va, qt + T::BYTES);
    };"""
BWD_GRADS = """        acc_product<D>(dva, pa, qt + T::BYTES);
        acc_product<D>(dka, dsa, qt);"""
BWD_MATH = """    auto math = [&](uint32_t qt) {"""
BWD_MATH_OFF = BWD_MATH + """
        if (held && signals) mbar_arrive(held);
        if (qt != 0xffffffffu) return;"""
BWD_LOGITS_OFF = """    auto logits = [&](uint32_t qt) {
        wgmma_commit();
        wgmma_commit();
    };"""
BWD_DKV_WAIT = """        wgmma_wait<1>();
        fence_acc(s);
        if (held && signals) mbar_arrive(held);
#pragma unroll
        for (int j = 0; j < BT / 8; ++j) {"""
BWD_DQ_WAIT = """        wgmma_wait<1>();
        fence_acc(s);
        if (held && signals) mbar_arrive(held);
#pragma unroll
        for (int j = 0; j < BT / 8; ++j)
#pragma unroll"""
# the forwards: the parent's mma.sync design (a copy of its source) and its
# ablations, which test whether its time is its products' plus its exps'
FWD_MMA_SYNC = "scripts/gemm_wgmma_variants/flash_fwd_mma_sync.cu"
PFWD_EXP = "p[e] = exp2_approx(fmaf(s[j][mt][e], c2, -m[mt][e >> 1]));"
PFWD_EXP_OFF = "p[e] = fmaf(s[j][mt][e], c2, -m[mt][e >> 1]);"
PFWD_S = "        rows_times_rows<MT, D>(s[j], qa, ks, j * 8, lane);"
# S from one shared-memory value a lane and n8 tile (the tile's, so that
# the exps stay per tile) instead of the products
PFWD_S_OFF = """        {
            const float x = __bfloat162float(
                ks[(j * 8 + (lane >> 2)) * att_ldt<D>() + (lane & 3)]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    s[j][mt][e] = x * (e + 1 + 4 * mt);
        }"""
PFWD_PV = "        acc_times_tile<MT, D>(o, pa, vs, kk * 16, lane);   // O += P·V"
PFWD_TILE = "        if (kv_left >= BKV) {"
PFWD_STREAM = "        if (kv_left >= 0) continue;\n" + PFWD_TILE
FWD_EXP = "s[j][e] = exp2_approx(fmaf(s[j][e], c2, -m[e >> 1]));"
FWD_EXP_OFF = "s[j][e] = fmaf(s[j][e], c2, -m[e >> 1]);"
FWD_S = "        WgmmaRS<N, 0>::run(s, qa[kk], Fwd<D>::rows(tile, kk), kk > 0);"
FWD_PV = "        WgmmaRS<D, 1>::run(o, pa[i], Fwd<D>::kmajor(tile, i));"
FWD_NO_PRODUCTS = {FWD_S: "        {}", FWD_PV: "        {}"}
FWD_MATH = "    auto math = [&](int t) {\n"
FWD_STREAM = {**FWD_NO_PRODUCTS, FWD_MATH: FWD_MATH + """\
        if (held && signals) mbar_arrive(held);
        if (t >= 0) return;
"""}
FWD_IN_STEP = {"__device__ __forceinline__ void my_turn(int cw) {":
               "__device__ __forceinline__ void my_turn(int cw) {\n"
               "    if (cw >= 0) return;",
               "__device__ __forceinline__ void your_turn(int cw) {":
               "__device__ __forceinline__ void your_turn(int cw) {\n"
               "    if (cw >= 0) return;"}
# p rounded to bf16 on the integer pipe (u + 0x7fff + bit 16, the high
# halves paired by PRMT) instead of F2FP
FWD_PACK = """        a[i][0] = pack_bf16(x[2 * i][0], x[2 * i][1]);
        a[i][1] = pack_bf16(x[2 * i][2], x[2 * i][3]);
        a[i][2] = pack_bf16(x[2 * i + 1][0], x[2 * i + 1][1]);
        a[i][3] = pack_bf16(x[2 * i + 1][2], x[2 * i + 1][3]);"""
FWD_INT_ROUND = {FWD_PACK: FWD_PACK.replace("pack_bf16(", "pack_int("),
                 "// two adjacent n8 tiles of an accumulator": """\
__device__ __forceinline__ uint32_t bf16_high(float x) {
    const uint32_t u = __float_as_uint(x);
    return u + 0x7fffu + ((u >> 16) & 1u);
}
__device__ __forceinline__ uint32_t pack_int(float lo, float hi) {
    return __byte_perm(bf16_high(lo), bf16_high(hi), 0x7632);
}

// two adjacent n8 tiles of an accumulator"""}
# K1's l summed by FADD from the bf16 pairs (unpacked by SHL/LOP), not by
# the tensor cores
FWD_L_FADD = {
    "    constexpr bool ONES = !ONLINE;   // K1's l from the tensor cores":
    "    constexpr bool ONES = false;",
    "// the k16 A fragments of the warpgroup's 64 rows": """\
__device__ __forceinline__ float pair_sum(uint32_t v) {
    return __uint_as_float(v << 16) + __uint_as_float(v & 0xffff0000u);
}
template <int I>
__device__ __forceinline__ void add_bf16_sums(float (&l)[2],
                                              const uint32_t (&a)[I][4]) {
#pragma unroll
    for (int i = 0; i < I; ++i) {
        l[0] += pair_sum(a[i][0]) + pair_sum(a[i][2]);
        l[1] += pair_sum(a[i][1]) + pair_sum(a[i][3]);
    }
}

// the k16 A fragments of the warpgroup's 64 rows""",
    "        pack_a<2>(pn, sn);\n":
    "        pack_a<2>(pn, sn);\n        add_bf16_sums(l, pn);\n",
    "        pack_a<BN / 8>(pa, s);\n":
    "        pack_a<BN / 8>(pa, s);\n"
    "        if (!ONLINE) add_bf16_sums(l, pa);\n"}
FWD_POLY_DEF = """\
// 2^x by a degree-5 polynomial on the FMA pipe (relative error 3.4e-7), 0
// below 2^-126 as ex2.approx.ftz: x = n + f, n = round(x) by the 1.5·2^23
// shift, 2^f on [−0.5, 0.5], n added to the exponent field
__device__ __forceinline__ float exp2_poly(float x) {
    const float xc = fmaxf(x, -127.f);
    const float j = __fadd_rn(xc, 12582912.f);
    const float f = __fsub_rn(xc, __fsub_rn(j, 12582912.f));
    float p = 1.2915660627186298e-3f;
    p = fmaf(p, f, 9.668532758951187e-3f);
    p = fmaf(p, f, 5.5516887456178665e-2f);
    p = fmaf(p, f, 0.24022264778614044f);
    p = fmaf(p, f, 0.6931464672088623f);
    p = fmaf(p, f, 1.f);
    const float r =
        __uint_as_float(__float_as_uint(p) + (__float_as_uint(j) << 23));
    return x < -126.f ? 0.f : r;
}

"""


def fwd_poly(n):
    """n of the 16 n8 tiles of a 128-key tile (a lane's 4n of 64 values)
    take their exps from exp2_poly, the rest from the exp unit."""
    return {"// The exps of one tile's S in s, in place":
            FWD_POLY_DEF + "// The exps of one tile's S in s, in place",
            FWD_EXP: f"s[j][e] = j < {n} ? exp2_poly(fmaf(s[j][e], c2, "
                     f"-m[e >> 1])) : exp2_approx(fmaf(s[j][e], c2, "
                     f"-m[e >> 1]));"}
FWD_C = "    static constexpr int C = 3;"
FWD_BN = "    static constexpr int BN = D == 64 ? 64 : 128;"
FWD_STAGES_4 = "    static constexpr int STAGES = 4;"


def fwd_variants(stage):
    """The forward's variants of one stage: at D 32 (K1_32, K15_32) the
    parent's design and its ablations, then the shipped design's, its
    ablations and its options; at D 16 and 64 the options of the tiling."""
    kind, d = FWD_STAGES[stage][:2]
    shipped = (f"{stage} shipped", "flash_fwd.cu", {}, stage)
    in_step = (f"{stage} consumers in step", "flash_fwd.cu", FWD_IN_STEP,
               stage)
    if d == 64:
        c2 = {FWD_C: "    static constexpr int C = 2;",
              FWD_BN: "    static constexpr int BN = 128;"}
        return [shipped, in_step,
                (f"{stage} two consumers, 128-key tiles", "flash_fwd.cu", c2,
                 stage),
                (f"{stage} two consumers, 128-key tiles, in step",
                 "flash_fwd.cu", {**c2, **FWD_IN_STEP}, stage)]
    if d == 16:
        return [shipped, in_step]
    out = [
        (f"{stage} parent design (mma.sync, cp.async ring)", FWD_MMA_SYNC,
         {}, stage),
        (f"{stage} parent ablation: no exps", FWD_MMA_SYNC,
         {PFWD_EXP: PFWD_EXP_OFF}, stage),
        (f"{stage} parent ablation: no products (S from one shared value a "
         f"lane and n8 tile, no P·V)", FWD_MMA_SYNC,
         {PFWD_S: PFWD_S_OFF, PFWD_PV: ""}, stage),
        (f"{stage} parent ablation: the stream only", FWD_MMA_SYNC,
         {PFWD_TILE: PFWD_STREAM}, stage),
        shipped,
        (f"{stage} ablation: no exps", "flash_fwd.cu",
         {FWD_EXP: FWD_EXP_OFF}, stage),
        (f"{stage} ablation: no products (the exps on stale registers)",
         "flash_fwd.cu", FWD_NO_PRODUCTS, stage),
        (f"{stage} ablation: the stream only", "flash_fwd.cu", FWD_STREAM,
         stage),
        in_step,
        (f"{stage} packs on the integer pipe", "flash_fwd.cu", FWD_INT_ROUND,
         stage),
        (f"{stage} two consumers", "flash_fwd.cu",
         {FWD_C: "    static constexpr int C = 2;"}, stage),
        (f"{stage} 64-key tiles", "flash_fwd.cu",
         {FWD_BN: "    static constexpr int BN = 64;"}, stage),
        (f"{stage} 64-key tiles, 6 stages", "flash_fwd.cu",
         {FWD_BN: "    static constexpr int BN = 64;",
          FWD_STAGES_4: "    static constexpr int STAGES = 6;"}, stage),
        (f"{stage} 6 stages", "flash_fwd.cu",
         {FWD_STAGES_4: "    static constexpr int STAGES = 6;"}, stage),
        *((f"{stage} {n} of 16 n8 tiles' exps by a polynomial",
           "flash_fwd.cu", fwd_poly(n), stage) for n in (3, 5)),
        (f"{stage} 4 of 16 n8 tiles' exps by a polynomial, in step",
         "flash_fwd.cu", {**fwd_poly(4), **FWD_IN_STEP}, stage),
    ]
    if kind == "K1":
        out += [(f"{stage} l summed by FADD (not the tensor cores)",
                 "flash_fwd.cu", FWD_L_FADD, stage),
                (f"{stage} l summed by FADD, in step", "flash_fwd.cu",
                 {**FWD_L_FADD, **FWD_IN_STEP}, stage)]
    return out


# the patch embedding's variants: PR 10's design, the two routes that lost
# (the video staged in every column tile with shared-memory-A wgmma and
# the statistics in the lanes; the video staged once per token tile by a
# cluster of the column tiles, forwarded by DSMEM), the shipped design's
# options, and ablations (each removes one part; only the time is read)
PE_MMA_SYNC = "scripts/gemm_wgmma_variants/patch_embed_mma_sync.cu"
PE_PER_TILE = "scripts/gemm_wgmma_variants/patch_embed_per_tile.cu"
PE_VIDEO_CLUSTER = "scripts/gemm_wgmma_variants/patch_embed_video_cluster.cu"
PE_NO_COPIES = {"for (int i = 0; i < TILE_M / G; ++i) {":
                "for (int i = 0; i < 0; ++i) {"}
PE_NO_READS = {"const bool ok = kin && base >= 0;": "const bool ok = false;"}
PE_NO_KC = {"if (pt == 0) {": "if (pt == 0 && k0 < 0) {",
            "1 + WG_THREADS, 8 * PE_CM>": "WG_THREADS, 8 * PE_CM>"}
PE_PRODUCT = """                WgmmaRS<PE_COLS, 0>::run(acc, fa[kk],
                                         smem_desc<false>(bt + kk * 32));"""
PE_STATS = """                WgmmaRS<8, 0>::run(st[0], fa[kk], smem_desc<false, 32>(ones));
                WgmmaRS<8, 0>::run(st[1], fq[kk], smem_desc<false, 32>(ones));"""
PE_NO_PRODUCTS = {PE_PRODUCT: ""}
PE_NO_STATS = {PE_STATS: ""}


def pe_variants(stage):
    return [
        (f"{stage} shipped", "patch_embed.cu", {}, stage),
        (f"{stage} PR 10's design (mma.sync from a cp.async ring, 96-token "
         "tiles)", PE_MMA_SYNC, {}, stage),
        (f"{stage} route (a): shared-memory-A wgmma, the statistics in the "
         "lanes from the tile, no kc multicast", PE_PER_TILE, {}, stage),
        (f"{stage} the video staged once per token tile (the column tiles "
         "a cluster, DSMEM forwarding), no kc multicast", PE_VIDEO_CLUSTER,
         {}, stage),
        (f"{stage} the same, clusters of one", PE_VIDEO_CLUSTER,
         {"a.cs = cluster_size(col_tiles);": "a.cs = 1;"}, stage),
        (f"{stage} no kc multicast (clusters of one)", "patch_embed.cu",
         {"PE_CM = 2;": "PE_CM = 1;"}, stage),
        (f"{stage} kc multicast to clusters of 4", "patch_embed.cu",
         {"PE_CM = 2;": "PE_CM = 4;"}, stage),
        (f"{stage} 3 stages", "patch_embed.cu",
         {"PE_STAGES = 4": "PE_STAGES = 3"}, stage),
        (f"{stage} 4 lanes a token (a warp's copy: 8 neighbouring tokens, "
         "16 k each)", "patch_embed.cu", {"PE_LPT = 16;": "PE_LPT = 4;"},
         stage),
        (f"{stage} 8 lanes a token", "patch_embed.cu",
         {"PE_LPT = 16;": "PE_LPT = 8;"}, stage),
        (f"{stage} one lane a token (a warp's copy: 32 neighbouring tokens, "
         "one piece each)", "patch_embed.cu", {"PE_LPT = 16;": "PE_LPT = 1;"},
         stage),
        (f"{stage} producer 56 registers, consumers 224", "patch_embed.cu",
         {"PE_PRODUCER_REGS = 40, PE_CONSUMER_REGS = 232":
          "PE_PRODUCER_REGS = 56, PE_CONSUMER_REGS = 224"}, stage),
        (f"{stage} video copies with an L2 prefetch of 128 bytes",
         "patch_embed.cu", {"cp.async.ca.shared.global [%0]":
                            "cp.async.ca.shared.global.L2::128B [%0]"},
         stage),
        (f"{stage} video copies with an L2 prefetch of 256 bytes",
         "patch_embed.cu", {"cp.async.ca.shared.global [%0]":
                            "cp.async.ca.shared.global.L2::256B [%0]"},
         stage),
        (f"{stage} ablation: no video copies", "patch_embed.cu",
         PE_NO_COPIES, stage),
        (f"{stage} ablation: no video reads (the copies zero-fill)",
         "patch_embed.cu", PE_NO_READS, stage),
        (f"{stage} ablation: no kc loads", "patch_embed.cu", PE_NO_KC, stage),
        (f"{stage} ablation: no products", "patch_embed.cu", PE_NO_PRODUCTS,
         stage),
        (f"{stage} ablation: no statistics", "patch_embed.cu", PE_NO_STATS,
         stage),
        (f"{stage} ablation: no token stores (the staging filled, no TMA "
         "store)", "patch_embed.cu",
         {"out.release(maps, cols, m0);": ""}, stage),
        (f"{stage} ablation: the products alone (no video copies, no "
         "statistics)", "patch_embed.cu", {**PE_NO_COPIES, **PE_NO_STATS},
         stage),
        (f"{stage} ablation: the stream alone (no products, no statistics)",
         "patch_embed.cu", {**PE_NO_PRODUCTS, **PE_NO_STATS}, stage),
    ]


VARIANTS = [
    *(v for st in ("K1_32", "K15_32", "K1_16", "K15_16", "K1_64", "K15_64")
      for v in fwd_variants(st)),
    ("dKdV32 shipped", "flash_bwd.cu", {}, "dKdV32"),
    ("dKdV32 consumers in step (no turns at the tensor cores)", BWD_IN_STEP,
     {}, "dKdV32"),
    ("dKdV32 S and dP with K, V from shared memory", "flash_bwd.cu",
     BWD_SS, "dKdV32"),
    ("dKdV32 6 stages", "flash_bwd.cu",
     {"constexpr int STAGES = 4;": "constexpr int STAGES = 6;"}, "dKdV32"),
    ("dKdV32 the exps after dP's products too", "flash_bwd.cu",
     {BWD_DKV_WAIT: BWD_DKV_WAIT.replace("wait<1>", "wait<0>")}, "dKdV32"),
    ("dKdV32 dS as the parent's p · (dP − δ) · scale", "flash_bwd.cu",
     {"q < Nq ? -ds[q] * scale : 0.f": "q < Nq ? ds[q] : 0.f",
      "q + 1 < Nq ? -ds[q + 1] * scale": "q + 1 < Nq ? ds[q + 1]",
      BWD_DS: "s[j][e] * (dp[j][e] - (e & 1 ? nd.y : nd.x)) * scale"},
     "dKdV32"),
    ("dKdV32 ablation: no exps (p = S·scale·log2e − lse·log2e)",
     "flash_bwd.cu", {BWD_EXP: BWD_EXP_OFF}, "dKdV32"),
    ("dKdV32 ablation: no exps, no dS arithmetic (dS = dP)",
     "flash_bwd.cu", {BWD_EXP: BWD_EXP_OFF, BWD_DS: "dp[j][e]"}, "dKdV32"),
    ("dKdV32 ablation: bf16 packs as one LOP3 (no F2FP)", "flash_bwd.cu",
     BWD_PACK_LOP, "dKdV32"),
    ("dKdV32 ablation: the products only (no exps, no dS arithmetic, "
     "LOP3 packs)", "flash_bwd.cu",
     {BWD_EXP: BWD_EXP_OFF, BWD_DS: "dp[j][e]", **BWD_PACK_LOP}, "dKdV32"),
    ("dKdV32 ablation: no Sᵀ, dPᵀ products (the math on stale registers)",
     "flash_bwd.cu", {BWD_LOGITS: BWD_LOGITS_OFF}, "dKdV32"),
    ("dKdV32 ablation: the stream only (each stage waited for and "
     "released)", "flash_bwd.cu",
     {BWD_LOGITS: BWD_LOGITS_OFF, BWD_GRADS: "", BWD_MATH: BWD_MATH_OFF},
     "dKdV32"),
    ("dQ32 shipped", "flash_bwd.cu", {}, "dQ32"),
    ("dQ32 consumers in step (no turns at the tensor cores)", BWD_IN_STEP,
     {}, "dQ32"),
    ("dQ32 three consumer warpgroups (192 queries a block)",
     "scripts/gemm_wgmma_variants/flash_bwd_dq3.cu", {}, "dQ32"),
    ("dQ32 S and dP with Q, dO from shared memory", "flash_bwd.cu",
     BWD_SS, "dQ32"),
    ("dQ32 2 stages", "flash_bwd.cu",
     {"constexpr int STAGES = 4;": "constexpr int STAGES = 2;",
      "constexpr int LOADERS = 3;": "constexpr int LOADERS = 2;"}, "dQ32"),
    ("dQ32 the exps after dP's products too", "flash_bwd.cu",
     {BWD_DQ_WAIT: BWD_DQ_WAIT.replace("wait<1>", "wait<0>")}, "dQ32"),
    ("dQ32 ablation: no exps", "flash_bwd.cu",
     {"s[j][e] = exp2_approx(fmaf(s[j][e], c2, nl[e >> 1]));":
      "s[j][e] = fmaf(s[j][e], c2, nl[e >> 1]);"}, "dQ32"),
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
    *(v for st in PE_STAGES for v in pe_variants(st)),
]


def variant_trial(stages) -> dict:
    """Each of VARIANTS of the given stages built and timed on the same
    inputs (mean of 20 launches after a warm-up), in the list's order."""
    device = torch.device("cuda")
    t = inputs(device)
    attn_inputs(device, t, stages)
    fwd_inputs(device, t, stages)
    pe_inputs(device, t, stages)
    variants = [v for v in VARIANTS if v[3] in stages]
    ref = twins(t, sorted({v[3] for v in variants}))
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

    def try_build(i, v):
        try:
            return build(i, v)
        except RuntimeError as e:   # reported, and the rest still run
            print(f"variant {v[0]}: build failed: {str(e)[-2000:]}",
                  flush=True)
            return None

    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda iv: try_build(*iv),
                              enumerate(variants)))
    out = {}
    for (label, _, _, stage), got in zip(variants, built):
        if got is None:
            out[label] = dict(build_failed=True)
            continue
        lib, log = got
        spills = [m.group(2) for m in re.finditer(
            r"entry function '(\w+)'[^\n]*\n(?:[^\n]*\n){0,2}?[^\n]*?"
            r"(\d+) bytes spill stores", log)
            if STAGE_KERNEL[stage].removesuffix("_kernel") in m.group(1)]
        st = Lib(lib).stages(t)[stage]
        st()
        torch.cuda.synchronize()
        errs = stage_errors(t, ref, stage)[
            :1 if stage in FWD_STAGES or stage in PE_STAGES else None]
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
           or r.get("this_lse_rel", 0) > LSE_RTOL
           or r.get("this_stats_rel", 0) > STATS_RTOL
           or not r["this_same_bits"]]
    if args.rates and args.parent is not None:
        res["rates"] = rates(args.parent.resolve())
    print(f"card: {res['card']}", flush=True)
    print(json.dumps(res), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
