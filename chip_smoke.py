#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. Requires a CUDA device (exits non-zero without one) and prints the card's
   name and power limit as nvidia-smi reports them.
2. Builds the hand-written kernels from ``vit_exp_tpu_torch/csrc`` and
   prints ptxas's registers and spills for K8's kernels and the int8
   attention (none may spill).
3. Holds each kernel against its plain PyTorch version at the shapes of the
   serving, training, int8 serving and run_train paths (batch 4, 13,824
   tokens, width 768; one row per launch counter: K1, K2's three kernels
   (x̂, act, out), K3, K4, K1 with lse, the
   two attention backward kernels, K8's six kernels (y, dh/act, dy, dx,
   the weight GEMM, the ordered sums), the int8 attention (K9/K10), K11's
   four kernels (y8, act, a8, out),
   K12/K13, K14, and K15 with and without lse and the two attention
   backward kernels over the 13,826 keys of the nulls concatenated to
   k/v), relative L2 error ≤ REL_L2_TOL and max abs error ≤
   MAX_ABS_TOL · max|plain|, and times both with CUDA events.  Each row also
   carries its bound (the least time an H100 could take: the largest of
   its bytes over the memory rate, its tensor-core and CUDA-core
   operations over the peak rates of their types, and, for the attention
   rows, its exps over the special-function units' rate, 16 per clock per
   SM at the SM clock nvidia-smi reports as clocks.max.sm) and, for K1,
   K15 and the attention backward pair, the time of torch's
   scaled_dot_product_attention on the same inputs (a yardstick, never on
   the path; its backward is timed once per input set and shared by the
   pair's two rows), for K8's weight GEMM torch.mm's, and for the products
   of K2 and K11 torch.mm's and torch._int_mm's (the products only, not the
   same function).  Checks that K1
   (with lse, 13,824 keys), K15 (with lse, 13,826 keys), the backward pair
   (13,826 keys), K2, K8 (both phases), the int8 attention and K11 each
   give the same bits twice (no atomics), prints K2's and K11's times as
   a whole, each forward's times against
   SDPA's forward and the pair's summed time against the one SDPA
   backward.
4. Runs the zero-shot serving path at full width (fused LN+qkv, as served):
   CTViT3D (8 blocks) + BERT-base with seeded random weights, 36 prompts of
   512 tokens, 4 random volumes of (1, 240, 480, 480), first in bf16, then
   int8 (W8A8, the JAX package's serving default) on the same weights.
   Checks finite (4, 18) probabilities in [0, 1], the launch counts of one
   ``predict_batch``, and that volume 0 agrees with the all-plain path on
   the card within PROB_TOL; for int8 also max |Δprob| ≤ INT8_PROB_TOL
   against the bf16 engine over GATE_BATCHES batches of volumes with a
   separable random field (the first half of
   scripts/int8_accuracy_gate.py; per-label rank AUROC and Kendall τ are
   printed, not bounded).  Times warm ``predict_batch`` calls, then
   profiles one more (device time by kernel and idle share,
   torch.profiler; the full tables go to chiprun_out/profile_serving.txt
   and profile_serving_int8.txt).
5. Runs the contrastive image-report train step at full width in the
   configuration of ``bench.py --train`` (batch 4, BERT-base at 512 tokens,
   lr 1e-5, max_grad_norm 0.5, Adam; unfused LN+qkv).  From one seeded
   state on one batch: the image tower's gradients for a seeded random
   cotangent on its output tokens, from one forward on the kernels, through
   the backward kernels and through their plain twins, each tensor within
   relative L2 TOWER_GRAD_RTOL; then one step on the plain versions and
   one on the kernels.  Checks finite losses
   within LOSS_RTOL, that every parameter the plain step gives a gradient
   also gets one from the kernel step, global gradient norms within
   GRAD_NORM_RTOL, and the launch counts of one step; prints the peak
   device memory; times warm steps and profiles one
   (chiprun_out/profile_train.txt; per-tensor errors in
   chiprun_out/train_grads.txt).  Then the same at run_train's default
   attention, attn_impl="pallas": K15 forward and the backward pair over
   the concatenated kv (chiprun_out/profile_train_pallas.txt,
   train_grads_pallas.txt).
6. Runs ``run_train.main`` at full width on a config derived from
   configs/prod_sustained_synth.yaml (hook list dropped, results in a
   temporary directory, removed at the end): 2 steps on 8 synthetic
   samples, a restore of ckpt_2 held bit for bit to the state the run
   ended with, ``--auto_resume`` to step 3; checks finite losses in
   metrics.jsonl and ckpt_2 and ckpt_3.  Then 6 steps over 64 samples:
   the trainer's steps/s, one profiled step's idle share
   (chiprun_out/profile_run_train.txt), the loader's wait per batch and
   the peak device memory.
7. Prints one JSON line with every kernel's numbers, the card line, the
   throughput lines, and last ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no "ok".
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

REL_L2_TOL = 1e-2   # bf16 outputs of the kernel vs fp32 plain arithmetic
# max abs error ≤ MAX_ABS_TOL · max|plain|: two bf16 ulps of the largest
# output (both sides round the same fp32 value up to summation order)
MAX_ABS_TOL = 2.0 ** -6
PROB_TOL = 0.02     # kernel path vs all-plain path, probabilities
# int8 engine vs bf16 engine on the same weights, max |Δprob| over
# GATE_BATCHES batches (scripts/int8_accuracy_gate.py's first bound)
INT8_PROB_TOL = 0.02
GATE_BATCHES = 4
# train step, kernel path vs plain path from the same state on the same batch
# (both bf16 with the same rounding points; the bounds leave room for bf16
# sums taken in another order through 8 blocks)
LOSS_RTOL = 1e-2
GRAD_NORM_RTOL = 0.05
# each image-tower gradient for a seeded cotangent on the tower's tokens,
# backward kernels vs their plain twins on one forward, relative L2 (at
# random weights the contrastive loss sits at chance and the image-side
# cotangents cancel across the batch, so the step's own tower gradients are
# bf16 noise on every path; a random cotangent gives every tensor a signal)
TOWER_GRAD_RTOL = 2e-2
ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# production serving shape (bench.py's zero-shot program)
ARCH = dict(dim=768, image_size=480, patch_size=20, temporal_size=240,
            temporal_patch_size=10, transformer_blocks=8, dim_head=32,
            heads=8, channels=1, use_flash_attention=True)
BATCH, TEXT_LEN, N_PROMPTS = 4, 512, 36
# bench.py --train: lr 1e-5, max_grad_norm 0.5, wd 0 (Adam)
TRAINER = dict(lr=1e-5, wd=0.0, max_grad_norm=0.5, warmup_steps=0,
               gradient_accumulation_steps=1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def check(ok: bool, what) -> None:
    """Fail the run (an explicit raise, which ``python -O`` keeps)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(a: torch.Tensor, b: torch.Tensor):
    """(relative L2 error, max abs error, max |b|) of a against reference b."""
    a, b = a.float(), b.float()
    rel = (torch.linalg.vector_norm(a - b)
           / torch.linalg.vector_norm(b).clamp_min(1e-30)).item()
    return rel, (a - b).abs().max().item(), b.abs().max().item()


# peak rates of one H100 SXM (NVIDIA's data sheet, dense): the bound of a
# kernel row is the largest of its bytes over HBM_BYTES_PER_S, the sum of
# its operations of each type over that type's peak, and its exps ("exp"
# in a Case's ops) over exp_per_s(), the special-function units' own pipe
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
EXP_PER_SM_CLOCK = 16   # MUFU ex2 results per clock per SM (sm_90)


@dataclasses.dataclass
class Case:
    """One kernel row: the kernel and its plain twin on the same inputs,
    the launch counter the row reports, the work that sets its bound
    (operations by type, bytes of the inputs; the outputs' bytes are added
    when they exist) and, where one PyTorch call computes the same
    function, a timer of that call (a yardstick, never on the path)."""
    name: str
    route: str
    source: str
    replaces: str
    kern: Callable
    plain: Callable
    counter: str
    ops: dict
    in_bytes: int
    library: Optional[Callable] = None


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


_EXP_PER_S = []


def exp_per_s() -> float:
    """The card's exp rate: EXP_PER_SM_CLOCK × its SMs × the SM clock that
    nvidia-smi reports as clocks.max.sm (queried once)."""
    if not _EXP_PER_S:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True, text=True,
            check=True).stdout.split()[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        _EXP_PER_S.append(EXP_PER_SM_CLOCK * sms * mhz * 1e6)
        print(f"exp unit: {EXP_PER_SM_CLOCK} per clock per SM × {sms} SMs × "
              f"{mhz:.0f} MHz (clocks.max.sm) = {_EXP_PER_S[0]:.4e} exps/s",
              flush=True)
    return _EXP_PER_S[0]


def bound(ops: dict, n_bytes: int, exps_per_s: float):
    """(least time in ms, what sets it, the pipe) for the given work on one
    H100 whose exp unit gives exps_per_s: "operations" on the tensor or
    CUDA cores ("ops") or on the exp unit ("exp"), or "bytes"."""
    times = {"ops": sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items()
                        if kind != "exp"),
             "exp": ops.get("exp", 0) / exps_per_s,
             "bytes": n_bytes / HBM_BYTES_PER_S}
    pipe = max(times, key=times.get)
    return (times[pipe] * 1e3, "bytes" if pipe == "bytes" else "operations",
            pipe)


def attention_ops(q, nkv, n_null=0, products=2):
    """Tensor-core operations of `products` (n × nkv × d) products over all
    (batch, head) rows, the nulls included, and one exp per logit."""
    b, h, n, d = q.shape
    logits = b * h * n * (nkv + n_null)
    return {"bf16": products * 2 * logits * d, "exp": logits}


def _sdpa_inputs(q, k, v, nk, nv, requires_grad=False):
    """Contiguous bf16 (b, h, n, d) copies for scaled_dot_product_attention,
    the nulls prepended to k and v."""
    b = q.shape[0]
    if nk is not None:
        k = torch.cat([nk[None].expand(b, -1, -1, -1).to(k.dtype), k], dim=2)
        v = torch.cat([nv[None].expand(b, -1, -1, -1).to(v.dtype), v], dim=2)
    return [t.detach().contiguous().requires_grad_(requires_grad)
            for t in (q, k, v)]


def sdpa_forward_timer(q, k, v, nk, nv, scale):
    """Timer of torch's scaled_dot_product_attention forward on the same q,
    k, v and nulls (the yardstick of K1)."""
    def timer():
        import torch.nn.functional as F
        qc, kc, vc = _sdpa_inputs(q, k, v, nk, nv)
        return cuda_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, scale=scale), 5)
    return timer


def sdpa_backward_timer(q, k, v, nk, nv, dout, scale):
    """Timer of torch's scaled_dot_product_attention backward: forward plus
    backward minus forward (the yardstick of the backward pair).  It times
    once; the pair's two rows report that one time."""
    measured = []

    def timer():
        if not measured:
            measured.append(time_sdpa_backward())
        return measured[0]

    def time_sdpa_backward():
        import torch.nn.functional as F
        qc, kc, vc = _sdpa_inputs(q, k, v, nk, nv, requires_grad=True)
        g = dout.contiguous()

        def fwd():
            return F.scaled_dot_product_attention(qc, kc, vc, scale=scale)

        def fwd_bwd():
            torch.autograd.grad(fwd(), (qc, kc, vc), g)

        with torch.no_grad():
            t_fwd = cuda_ms(fwd, 5)
        return cuda_ms(fwd_bwd, 5) - t_fwd
    return timer


def kernel_cases(device, arch=ARCH, batch=BATCH, seed=0):
    """K1-K4 at the serving path's shapes, as Cases; inputs are bf16."""
    from vit_exp_tpu_torch.ops import fused_proj, geglu_ff, patches
    from vit_exp_tpu_torch.ops import flash_attention as fa
    from vit_exp_tpu_torch.ops.attention import l2norm

    g = torch.Generator(device=device).manual_seed(seed)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=device) * std).to(bf)

    d, h, dh = arch["dim"], arch["heads"], arch["dim_head"]
    t = arch["temporal_size"] // arch["temporal_patch_size"]
    s = arch["image_size"] // arch["patch_size"]
    n = t * s * s
    m = batch * n
    inner = int(4.0 * 2 / 3 * d)

    # K1: q/k/v as the model hands them over: strided views of the packed
    # (b, n, h·d) projection outputs, l2-normalised, 2 nulls per head
    qp = l2norm(randn(batch, n, h, dh)).transpose(1, 2)
    kvp = randn(batch, n, 2 * h * dh)
    k = l2norm(kvp[..., :h * dh].reshape(batch, n, h, dh)).transpose(1, 2)
    v = kvp[..., h * dh:].reshape(batch, n, h, dh).transpose(1, 2)
    nk, nv = l2norm(randn(h, 2, dh)), randn(h, 2, dh)
    scale = 1.0 / math.sqrt(dh)
    bound_t = torch.tensor(scale, device=device)
    k1 = (qp, k, v, nk, nv, bound_t, scale)

    # K2 / K3: token matrix with its LN statistics
    x = randn(m, d)
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    w1p, w2 = randn(d, 2 * inner, std=d ** -0.5), randn(inner, d, std=inner ** -0.5)
    d1 = randn(2 * inner, std=0.1).float()
    wf = randn(d, 3 * h * dh, std=d ** -0.5)
    c = torch.cat([wf[:, :h * dh].float().sum(0),
                   torch.zeros(2 * h * dh, device=device)])

    # K2's stages take the kernel chain's inputs
    k2 = (x, mu, inv, w1p, d1, w2)
    whole_kernel(lambda: (geglu_ff.geglu_ff(*k2),),
                 f"K2 over {m} tokens (x̂, act, out)", device)
    xn = geglu_ff.geglu_ff_x(x, mu, inv)
    act = geglu_ff.geglu_ff_h(xn, w1p, d1)
    ff = "vit_exp_tpu_torch/csrc/geglu_ff.cu"
    k2_src = "vit_exp_tpu/ops/geglu_ff.py:63"

    # K4: the video as (b·t, c·pt, H, W)
    video = randn(batch * t, arch["channels"] * arch["temporal_patch_size"],
                  arch["image_size"], arch["image_size"])
    p = arch["patch_size"]

    return [
        Case("K1 static-max attention", "cuda",
             "vit_exp_tpu_torch/csrc/flash_fwd.cu",
             "vit_exp_tpu/ops/flash_attention.py:78",
             lambda: fa.attention_static(*k1),
             lambda: fa.attention_static_plain(*k1), "K1",
             attention_ops(qp, n, 2), nbytes(qp, k, v, nk, nv),
             sdpa_forward_timer(qp, k, v, nk, nv, scale)),
        Case("K2 GEGLU feed-forward: x̂ = bf16((x − μ)·inv)", "cuda", ff,
             k2_src, lambda: geglu_ff.geglu_ff_x(x, mu, inv),
             lambda: geglu_ff.geglu_ff_x_plain(x, mu, inv), "K2x", {},
             nbytes(x, mu, inv)),
        Case("K2 GEGLU feed-forward: act (x̂·W1' + d1, the GEGLU in the "
             "epilogue)", "cuda", ff, k2_src,
             lambda: geglu_ff.geglu_ff_h(xn, w1p, d1),
             lambda: geglu_ff.geglu_ff_h_plain(xn, w1p, d1), "K2h",
             {"bf16": 2 * m * d * 2 * inner}, nbytes(xn, w1p, d1),
             product_timer("K2's act stage: torch.mm(x̂, W1')",
                           lambda: torch.mm(xn, w1p))),
        Case("K2 GEGLU feed-forward: out = act·W2", "cuda", ff, k2_src,
             lambda: geglu_ff.geglu_ff_o(act, w2),
             lambda: geglu_ff.geglu_ff_o_plain(act, w2), "K2o",
             {"bf16": 2 * m * inner * d}, nbytes(act, w2),
             product_timer("K2's out stage: torch.mm(act, W2)",
                           lambda: torch.mm(act, w2))),
        Case("K3 fused LN + qkv projection", "cuda",
             "vit_exp_tpu_torch/csrc/ln_qkv.cu",
             "vit_exp_tpu/ops/fused_proj.py:43",
             lambda: fused_proj.ln_qkv(x, mu, inv, wf, c, h * dh),
             lambda: fused_proj.ln_qkv_plain(x, mu, inv, wf, c, h * dh), "K3",
             {"bf16": 2 * m * d * wf.shape[1]}, nbytes(x, mu, inv, wf, c)),
        Case("K4 patch statistics", "cuda",
             "vit_exp_tpu_torch/csrc/patch_stats.cu",
             "vit_exp_tpu/ops/patches.py:56",
             lambda: patches.patch_stats(video, p, p),
             lambda: patches.patch_stats_plain(video, p, p), "K4",
             {"fp32": 2 * video.numel()}, nbytes(video)),
    ]


def training_kernel_cases(device, arch=ARCH, batch=BATCH, seed=2):
    """The training path's kernel rows at its shapes: K1 with lse, the two
    attention backward kernels (each against its outputs of the plain
    backward twin) and K8's six kernels, one row each (each row's kernel and
    twin take the kernel chain's inputs; the weight GEMM's row carries
    torch.mm as its yardstick).  Checks first that K8 as a whole gives the
    same bits twice."""
    from vit_exp_tpu_torch.ops import geglu_ff
    from vit_exp_tpu_torch.ops import flash_attention as fa
    from vit_exp_tpu_torch.ops.attention import l2norm

    g = torch.Generator(device=device).manual_seed(seed)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=device) * std

    d, h, dh = arch["dim"], arch["heads"], arch["dim_head"]
    n = (arch["temporal_size"] // arch["temporal_patch_size"]
         * (arch["image_size"] // arch["patch_size"]) ** 2)
    m = batch * n
    inner = int(4.0 * 2 / 3 * d)

    def heads(t):   # (b, n, h·d) → strided (b, h, n, d) view
        return t.reshape(batch, n, h, dh).transpose(1, 2)

    q = l2norm(heads(randn(batch, n, h * dh).to(bf)))
    k = l2norm(heads(randn(batch, n, h * dh).to(bf)))
    v = heads(randn(batch, n, h * dh).to(bf))
    nk, nv = l2norm(randn(h, 2, dh).to(bf)), randn(h, 2, dh).to(bf)
    scale = 1.0 / math.sqrt(dh)
    bound_t = torch.tensor(scale, device=device)
    fwd = (q, k, v, nk, nv, bound_t, scale)
    dout = heads(randn(batch, n, h * dh, std=1e-3).to(bf))
    same_bits_twice(lambda: fa.attention_static(*fwd, save_lse=True),
                    f"K1 with lse over {n} keys and 2 nulls: out and lse")
    out, lse = fa.attention_static_plain(*fwd, save_lse=True)
    delta = (dout.float() * out.float()).sum(-1)
    bwd = (q, k, v, dout, lse, delta, scale)
    del out

    x = randn(m, d).to(bf)
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    gamma, beta = 1 + 0.1 * randn(d), 0.1 * randn(d)
    w1 = randn(d, 2 * inner, std=d ** -0.5).to(bf)
    w2 = randn(inner, d, std=inner ** -0.5).to(bf)
    dout_ff = randn(m, d, std=1e-3).to(bf)
    ff = (x, mu, inv, gamma, beta, w1, w2, dout_ff)
    same_bits_twice(lambda: geglu_ff.geglu_ff_bwd(*ff),
                    f"K8, both phases, over {m} tokens: dx, dW1, dW2, dgamma, "
                    f"dbeta")
    # each stage's row takes the kernel chain's inputs
    y = geglu_ff.geglu_bwd_y(x, mu, inv, gamma, beta)
    dh_, act = geglu_ff.geglu_bwd_dh(y, dout_ff, w1, w2)
    dy = geglu_ff.geglu_bwd_dy(dh_, w1)
    _, dgp, dbp = geglu_ff.geglu_bwd_dx(x, mu, inv, gamma, dy)
    gemms = [(a, b, *geglu_ff.wgrad_plan(m, a.shape[1], b.shape[1]))
             for a, b in ((y, dh_), (act, dout_ff))]
    sums = [geglu_ff.wgrad_partials(*gm) for gm in gemms] + [dgp, dbp]
    flash_bwd = "vit_exp_tpu_torch/csrc/flash_bwd.cu"
    k5 = "vit_exp_tpu/ops/flash_attention.py:868"
    ff_bwd = "vit_exp_tpu_torch/csrc/geglu_ff_bwd.cu"
    k8 = "vit_exp_tpu/ops/geglu_ff.py:134"
    sdpa_bwd = sdpa_backward_timer(q, k, v, nk, nv, dout, scale)
    # the kv side of the backward: S, dP, dV, dK; the q side: S, dP, dQ
    bwd_bytes = nbytes(q, k, v, dout, lse, delta)

    return [
        Case("K1 static-max attention + lse (training)", "cuda",
             "vit_exp_tpu_torch/csrc/flash_fwd.cu",
             "vit_exp_tpu/ops/flash_attention.py:78",
             lambda: fa.attention_static(*fwd, save_lse=True),
             lambda: fa.attention_static_plain(*fwd, save_lse=True), "K1",
             attention_ops(q, n, 2), nbytes(q, k, v, nk, nv),
             sdpa_forward_timer(q, k, v, nk, nv, scale)),
        Case("K5/K7 attention backward: dK/dV kernel", "cuda", flash_bwd, k5,
             lambda: fa.attention_bwd_dkv(*bwd),
             lambda: fa.attention_bwd_plain(*bwd)[1:], "dKdV",
             attention_ops(q, n, products=4), bwd_bytes, sdpa_bwd),
        Case("K5/K6 attention backward: dQ kernel", "cuda", flash_bwd, k5,
             lambda: fa.attention_bwd_dq(*bwd),
             lambda: fa.attention_bwd_plain(*bwd)[0], "dQ",
             attention_ops(q, n, products=3), bwd_bytes, sdpa_bwd),
        Case("K8 GEGLU backward, token phase: y = bf16(x̂·γ + β)", "cuda",
             ff_bwd, k8, lambda: geglu_ff.geglu_bwd_y(x, mu, inv, gamma, beta),
             lambda: geglu_ff.geglu_bwd_y_plain(x, mu, inv, gamma, beta),
             "K8y", {}, nbytes(x, mu, inv, gamma, beta)),
        Case("K8 GEGLU backward, token phase: dh and act (dO·W2ᵀ, y·W1, "
             "the GEGLU derivative)", "cuda", ff_bwd, k8,
             lambda: geglu_ff.geglu_bwd_dh(y, dout_ff, w1, w2),
             lambda: geglu_ff.geglu_bwd_dh_plain(y, dout_ff, w1, w2), "K8dh",
             {"bf16": 2 * m * d * 3 * inner}, nbytes(y, dout_ff, w1, w2)),
        Case("K8 GEGLU backward, token phase: dy = dh·W1ᵀ (fp32)", "cuda",
             ff_bwd, k8, lambda: geglu_ff.geglu_bwd_dy(dh_, w1),
             lambda: geglu_ff.geglu_bwd_dy_plain(dh_, w1), "K8dy",
             {"bf16": 2 * m * 2 * inner * d}, nbytes(dh_, w1)),
        Case("K8 GEGLU backward, token phase: dx and the dgamma/dbeta "
             "partials", "cuda", ff_bwd, k8,
             lambda: geglu_ff.geglu_bwd_dx(x, mu, inv, gamma, dy),
             lambda: geglu_ff.geglu_bwd_dx_plain(x, mu, inv, gamma, dy),
             "K8dx", {}, nbytes(x, mu, inv, gamma, dy)),
        Case("K8 GEGLU backward, weight phase: split-K partials of dW1 = "
             "yᵀdh and dW2 = actᵀdO", "cuda", ff_bwd, k8,
             lambda: tuple(geglu_ff.wgrad_partials(*gm) for gm in gemms),
             lambda: tuple(geglu_ff.wgrad_partials_plain(*gm) for gm in gemms),
             "K8w", {"bf16": 2 * m * d * 3 * inner},
             nbytes(y, dh_, act, dout_ff),
             mm_timer([gm[:2] for gm in gemms])),
        Case("K8 GEGLU backward, weight phase: ordered sums of the partials "
             "(dW1, dW2, dgamma, dbeta)", "cuda", ff_bwd, k8,
             lambda: tuple(geglu_ff.sum_rows(t) for t in sums),
             lambda: tuple(geglu_ff.sum_rows_plain(t) for t in sums),
             "K8sum", {}, nbytes(*sums)),
    ]


def mm_timer(pairs):
    """Timer of torch.mm(a.t(), b) over the (a, b) pairs: the weight
    GEMM's yardstick, never on the path.  fp32 output (out_dtype) where the
    installed torch takes it, else bf16; it prints which."""
    def timer():
        a, b = pairs[0]
        try:
            torch.mm(a[:8].t(), b[:8], out_dtype=torch.float32)
            kw, kind = {"out_dtype": torch.float32}, "fp32 output (out_dtype)"
        except (TypeError, RuntimeError):
            kw, kind = {}, "bf16 output (this torch's mm takes no out_dtype)"
        print(f"weight GEMM yardstick: torch.mm(a.t(), b) with {kind}",
              flush=True)
        return cuda_ms(lambda: [torch.mm(a.t(), b, **kw) for a, b in pairs], 5)
    return timer


def product_timer(what: str, fn):
    """Timer of one library call that computes a stage's product alone,
    not the same function as the stage (a yardstick, never on the path);
    it prints which call."""
    def timer():
        print(f"yardstick of {what} (the products only, not the same "
              f"function)", flush=True)
        return cuda_ms(fn, 5)
    return timer


def int_mm_timer(what: str, a8, b8):
    """product_timer of torch._int_mm(a8, b8) (int32 out) where the
    installed torch has it, else a timer that prints so and gives None."""
    def timer():
        try:
            torch._int_mm(a8[:32], b8)
        except (AttributeError, RuntimeError) as e:
            print(f"yardstick of {what}: torch._int_mm not available "
                  f"({type(e).__name__}: {e})", flush=True)
            return None
        return product_timer(f"{what}: torch._int_mm",
                             lambda: torch._int_mm(a8, b8))()
    return timer


def whole_kernel(fn, what: str, device) -> None:
    """fn, a kernel's stages composed, gives the same bits twice; on the
    card also prints its time as a whole (mean of 5 launches after a
    warm-up)."""
    same_bits_twice(fn, what)
    if device.type == "cuda":
        print(f"{what} as a whole: {cuda_ms(fn, 5):.3f} ms", flush=True)


def int8_kernel_cases(device, arch=ARCH, batch=BATCH, seed=4):
    """The int8 serving path's kernel rows at its shapes, with inputs made
    as the model makes them: weights quantized per channel, q/k after the
    l2norm and their scales and then the prologue's quantization, v a
    strided view of the packed v output, the nulls as the model prepares
    them."""
    from vit_exp_tpu_torch.ops import fused_proj, geglu_ff
    from vit_exp_tpu_torch.ops import flash_attention as fa
    from vit_exp_tpu_torch.ops.attention import l2norm, logit_bound

    g = torch.Generator(device=device).manual_seed(seed)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=device) * std

    d, h, dh = arch["dim"], arch["heads"], arch["dim_head"]
    n = (arch["temporal_size"] // arch["temporal_patch_size"]
         * (arch["image_size"] // arch["patch_size"]) ** 2)
    m = batch * n
    hd = h * dh
    inner = int(4.0 * 2 / 3 * d)

    x = randn(m, d).to(bf)
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    gamma, beta = 1 + 0.1 * randn(d), 0.1 * randn(d)

    # K12/K13: [γ⊙Wq | Wkv] quantized per channel
    w8, sc, c = fused_proj.int8_qkv_weights(
        gamma, randn(d, hd, std=d ** -0.5), randn(d, 2 * hd, std=d ** -0.5))
    qkv = (x, mu, inv, w8, sc, c, hd, hd)

    # K9/K10: the prologue's int8 q/k and scales, v in place
    def heads(t):
        return t.reshape(batch, n, h, dh).transpose(1, 2)

    q_scale, k_scale = 1 + 0.1 * randn(dh), 1 + 0.1 * randn(dh)
    q = l2norm(heads(randn(batch, n, hd).to(bf))) * q_scale.to(bf)
    k = l2norm(heads(randn(batch, n, hd).to(bf))) * k_scale.to(bf)
    v = heads(randn(batch, n, hd).to(bf))
    scale = 1.0 / math.sqrt(dh)
    q8, k8, qe, qn = fa.quantize_qk(q, k, scale)
    nk = l2norm(randn(h, 2, dh)) * k_scale
    nv = randn(h, 2, dh).to(bf)
    attn = (q8, k8, v, qe, qn, nk, nv, logit_bound(q_scale, k_scale, scale))
    del q, k
    same_bits_twice(lambda: (fa.attention_static_int8(*attn),),
                    f"K9/K10 over {n} keys and 2 nulls: out")

    # K11: W1, W2 quantized per channel
    w1q, s1 = geglu_ff.quantize_per_channel(randn(d, 2 * inner,
                                                  std=d ** -0.5))
    w2q, s2 = geglu_ff.quantize_per_channel(randn(inner, d,
                                                  std=inner ** -0.5))
    ff = (x, mu, inv, gamma, beta, w1q, s1, w2q, s2)
    whole_kernel(lambda: (geglu_ff.geglu_ff_int8(*ff),),
                 f"K11 over {m} tokens (y8, act, a8, out)", device)
    # K11's stages take the kernel chain's inputs; the weights transposed
    # as geglu_ff_int8 hands them over
    w1t, w2t = w1q.t().contiguous(), w2q.t().contiguous()
    y8, sy = geglu_ff.geglu_ff_int8_y(x, mu, inv, gamma, beta)
    act, part = geglu_ff.geglu_ff_int8_h(y8, sy, w1t, s1)
    a8, sa = geglu_ff.geglu_ff_int8_q(act, part)
    ff8 = "vit_exp_tpu_torch/csrc/geglu_ff_int8.cu"
    k11 = "vit_exp_tpu/ops/geglu_ff.py:341"

    # K14: the attention output (b·n, h·d) against to_out
    xo = randn(m, hd, std=0.3).to(bf)
    wo8, so = geglu_ff.quantize_per_channel(randn(hd, d, std=hd ** -0.5))

    proj = "vit_exp_tpu_torch/csrc/ln_qkv_int8.cu"
    return [
        Case("K9/K10 int8 static-max attention", "cuda",
             "vit_exp_tpu_torch/csrc/flash_static_int8.cu",
             "vit_exp_tpu/ops/flash_attention.py:506",
             lambda: fa.attention_static_int8(*attn),
             lambda: fa.attention_static_int8_plain(*attn), "K9/K10",
             {"int8": attention_ops(q8, n, 2, products=1)["bf16"],
              **attention_ops(q8, n, 2, products=1)}, nbytes(*attn)),
        Case("K11 W8A8 GEGLU feed-forward: y8, s_y (y = x̂·γ + β per "
             "token)", "cuda", ff8, k11,
             lambda: geglu_ff.geglu_ff_int8_y(x, mu, inv, gamma, beta),
             lambda: geglu_ff.geglu_ff_int8_y_plain(x, mu, inv, gamma, beta),
             "K11y", {}, nbytes(x, mu, inv, gamma, beta)),
        Case("K11 W8A8 GEGLU feed-forward: act and its partial amaxes "
             "(y8·W1, the GEGLU in the epilogue)", "cuda", ff8, k11,
             lambda: geglu_ff.geglu_ff_int8_h(y8, sy, w1t, s1),
             lambda: geglu_ff.geglu_ff_int8_h_plain(y8, sy, w1t, s1), "K11h",
             {"int8": 2 * m * d * 2 * inner}, nbytes(y8, sy, w1t, s1),
             int_mm_timer("K11's act stage", y8, w1t.t())),
        Case("K11 W8A8 GEGLU feed-forward: a8, s_a", "cuda", ff8, k11,
             lambda: geglu_ff.geglu_ff_int8_q(act, part),
             lambda: geglu_ff.geglu_ff_int8_q_plain(act, part), "K11q", {},
             nbytes(act, part)),
        Case("K11 W8A8 GEGLU feed-forward: out = a8·W2·s_a·s_W2", "cuda",
             ff8, k11, lambda: geglu_ff.geglu_ff_int8_o(a8, sa, w2t, s2),
             lambda: geglu_ff.geglu_ff_int8_o_plain(a8, sa, w2t, s2), "K11o",
             {"int8": 2 * m * inner * d}, nbytes(a8, sa, w2t, s2),
             int_mm_timer("K11's out stage", a8, w2t.t())),
        Case("K12/K13 W8A8 LN + q/k/v projection", "cuda", proj,
             "vit_exp_tpu/ops/fused_proj.py:260",
             lambda: fused_proj.ln_qkv_int8(*qkv),
             lambda: fused_proj.ln_qkv_int8_plain(*qkv), "K12/K13",
             {"int8": 2 * m * d * 3 * hd}, nbytes(*qkv[:6])),
        Case("K14 W8A8 out-projection", "cuda", proj,
             "vit_exp_tpu/ops/fused_proj.py:358",
             lambda: fused_proj.proj_int8(xo, wo8, so),
             lambda: fused_proj.proj_int8_plain(xo, wo8, so), "K14",
             {"int8": 2 * m * hd * d}, nbytes(xo, wo8, so)),
    ]


def same_bits_twice(fn, what: str) -> None:
    """fn, launched twice on the same inputs, gives the same bits (the
    attention kernels use no atomics); prints and checks it."""
    runs = [fn() for _ in range(2)]
    if runs[0][0].is_cuda:
        torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"{what}, twice on the same inputs: bitwise equal: {same}",
          flush=True)
    check(same, f"{what} is not bit-reproducible")


def online_kernel_cases(device, arch=ARCH, batch=BATCH, seed=6):
    """The run_train path's attention rows (attn_impl="pallas") at its
    shapes: K15 with and without lse over the 2 nulls concatenated in
    front of k/v (13,826 keys at full width, so the last 64-key tile holds
    2 keys), and the backward pair over the same concatenated kv, each
    against its plain twin; SDPA on the same q and concatenated k/v as the
    yardstick.  Checks first that K15 and the pair are bitwise
    deterministic on these inputs."""
    from vit_exp_tpu_torch.ops import flash_attention as fa
    from vit_exp_tpu_torch.ops.attention import l2norm

    g = torch.Generator(device=device).manual_seed(seed)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=device) * std

    h, dh = arch["heads"], arch["dim_head"]
    n = (arch["temporal_size"] // arch["temporal_patch_size"]
         * (arch["image_size"] // arch["patch_size"]) ** 2)

    def heads(t):   # (b, n, h·d) → strided (b, h, n, d) view
        return t.reshape(batch, n, h, dh).transpose(1, 2)

    def with_nulls(t, nt):
        return torch.cat([nt[None].expand(batch, -1, -1, -1), t], dim=2)

    q = l2norm(heads(randn(batch, n, h * dh).to(bf)))
    k = with_nulls(l2norm(heads(randn(batch, n, h * dh).to(bf))),
                   l2norm(randn(h, 2, dh).to(bf)))
    v = with_nulls(heads(randn(batch, n, h * dh).to(bf)),
                   randn(h, 2, dh).to(bf))
    nkv = k.shape[2]
    scale = 1.0 / math.sqrt(dh)
    fwd = (q, k, v, scale)
    dout = heads(randn(batch, n, h * dh, std=1e-3).to(bf))
    same_bits_twice(lambda: fa.attention_online(*fwd, save_lse=True),
                    f"K15 with lse over {nkv} keys: out and lse")
    out, lse = fa.attention_online_plain(*fwd, save_lse=True)
    delta = (dout.float() * out.float()).sum(-1)
    bwd = (q, k, v, dout, lse, delta, scale)
    del out
    same_bits_twice(lambda: (*fa.attention_bwd_dkv(*bwd),
                             fa.attention_bwd_dq(*bwd)),
                    f"attention backward pair over {nkv} keys: dK, dV, dQ")
    src = "vit_exp_tpu_torch/csrc/flash_fwd.cu"
    k15 = "vit_exp_tpu/ops/flash_attention.py:148"
    flash_bwd = "vit_exp_tpu_torch/csrc/flash_bwd.cu"
    sdpa_fwd = sdpa_forward_timer(q, k, v, None, None, scale)
    sdpa_bwd = sdpa_backward_timer(q, k, v, None, None, dout, scale)
    bwd_bytes = nbytes(q, k, v, dout, lse, delta)
    return [
        Case("K15 online-softmax attention", "cuda", src, k15,
             lambda: fa.attention_online(*fwd),
             lambda: fa.attention_online_plain(*fwd), "K15",
             attention_ops(q, nkv), nbytes(q, k, v), sdpa_fwd),
        Case("K15 online-softmax attention + lse (training)", "cuda", src,
             k15, lambda: fa.attention_online(*fwd, save_lse=True),
             lambda: fa.attention_online_plain(*fwd, save_lse=True), "K15",
             attention_ops(q, nkv), nbytes(q, k, v), sdpa_fwd),
        Case("K7 attention backward over the concatenated kv: dK/dV kernel",
             "cuda", flash_bwd, "vit_exp_tpu/ops/flash_attention.py:758",
             lambda: fa.attention_bwd_dkv(*bwd),
             lambda: fa.attention_bwd_plain(*bwd)[1:], "dKdV",
             attention_ops(q, nkv, products=4), bwd_bytes,
             sdpa_bwd),
        Case("K6 attention backward over the concatenated kv: dQ kernel",
             "cuda", flash_bwd, "vit_exp_tpu/ops/flash_attention.py:725",
             lambda: fa.attention_bwd_dq(*bwd),
             lambda: fa.attention_bwd_plain(*bwd)[0], "dQ",
             attention_ops(q, nkv, products=3), bwd_bytes,
             sdpa_bwd),
    ]


# the kernels whose ptxas registers and spills are printed (and must not
# spill): K2's three, K8's six, the int8 attention and K11's four
REPORTED_KERNELS = ("geglu_ff_x_kernel", "geglu_ff_h_kernel",
                    "geglu_ff_o_kernel",
                    "geglu_bwd_y_kernel", "geglu_bwd_dh_kernel",
                    "geglu_bwd_dy_kernel", "geglu_bwd_dx_kernel",
                    "wgrad_kernel", "sum_rows_kernel",
                    "flash_static_int8_kernel",
                    "geglu_int8_y_kernel", "geglu_int8_h_kernel",
                    "geglu_int8_q_kernel", "geglu_int8_o_kernel")


def ptxas_report(log: str, names) -> dict:
    """name → (registers, spill store bytes, spill load bytes) for each
    entry function whose (mangled) name holds one of ``names``, read from
    nvcc's -Xptxas -v output."""
    out, entry, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            for name in names:
                if name in entry:
                    out[name] = (int(m.group(1)), *spills)
            entry = None
    return out


def kernel_counters():
    from vit_exp_tpu_torch.ops import fused_proj, geglu_ff, patches
    from vit_exp_tpu_torch.ops import flash_attention as fa

    return {"K1": fa.attention_static, "K2x": geglu_ff.geglu_ff_x,
            "K2h": geglu_ff.geglu_ff_h, "K2o": geglu_ff.geglu_ff_o,
            "K3": fused_proj.ln_qkv, "K4": patches.patch_stats,
            "dKdV": fa.attention_bwd_dkv, "dQ": fa.attention_bwd_dq,
            "K8y": geglu_ff.geglu_bwd_y, "K8dh": geglu_ff.geglu_bwd_dh,
            "K8dy": geglu_ff.geglu_bwd_dy, "K8dx": geglu_ff.geglu_bwd_dx,
            "K8w": geglu_ff.wgrad_partials, "K8sum": geglu_ff.sum_rows,
            "K9/K10": fa.attention_static_int8,
            "K11y": geglu_ff.geglu_ff_int8_y, "K11h": geglu_ff.geglu_ff_int8_h,
            "K11q": geglu_ff.geglu_ff_int8_q, "K11o": geglu_ff.geglu_ff_int8_o,
            "K12/K13": fused_proj.ln_qkv_int8, "K14": fused_proj.proj_int8,
            "K15": fa.attention_online}


def expected_launches(counts: dict) -> dict:
    """Every launch counter at 0 but the ones given."""
    return {k: counts.get(k, 0) for k in kernel_counters()}


def count_launches(fn):
    """Run fn with every launch count set to 0 just before; return its
    result and the counts just after."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    return out, {k: c.launches for k, c in counters.items()}


def pair_line(rows: dict, card: str) -> str:
    """The backward pair's summed time against the one SDPA backward on the
    same inputs, over the real kv (the training rows: 13,824 keys at full
    width) and over the concatenated kv (the online rows: 13,826)."""
    parts = []
    for phase, kv_name in (("train", "real kv"), ("online", "concatenated kv")):
        kv, dq = (next(r for r in rows[phase] if r["counter"] == c)
                  for c in ("dKdV", "dQ"))
        pair, sdpa = kv["ms"] + dq["ms"], kv["library_ms"]
        parts.append(f"over the {kv_name} dK/dV {kv['ms']:.3f} + dQ "
                     f"{dq['ms']:.3f} = {pair:.3f} ms against SDPA's backward "
                     f"{sdpa:.3f} ms, factor {pair / sdpa:.3f}")
    return f"attention backward pair: {'; '.join(parts)}; on {card}"


def forward_lines(rows: dict, card: str) -> list:
    """Each attention forward's times against SDPA's forward on the same
    inputs: K1 on the serving and training rows (13,824 keys and 2 nulls),
    K15 with and without lse (13,826 concatenated keys)."""
    lines = []
    for counter, phases in (("K1", ("serve", "train")), ("K15", ("online",))):
        parts = [f"{r['name']} {r['ms']:.3f} ms against SDPA's forward "
                 f"{r['library_ms']:.3f} ms, factor "
                 f"{r['ms'] / r['library_ms']:.3f} (bound {r['bound_ms']:.3f} "
                 f"ms)" for phase in phases for r in rows[phase]
                 if r["counter"] == counter]
        lines.append(f"attention forward {counter}: {'; '.join(parts)}; on "
                     f"{card}")
    return lines


def compare_kernels(cases):
    """Hold each case's kernel against its plain version and time both (and
    the library call, where there is one); returns the JSON rows (launches
    filled in later)."""
    rows = []
    for case in cases:
        out_k, out_p = case.kern(), case.plain()
        torch.cuda.synchronize()
        outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
        outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
        errs = [compare(a, b) for a, b in zip(outs_k, outs_p)]
        rel, mx = max(e[0] for e in errs), max(e[1] for e in errs)
        abs_ok = all(e[1] <= MAX_ABS_TOL * e[2] for e in errs)
        ok_finite = all(torch.isfinite(a.float()).all().item() for a in outs_k)
        bound_ms, bound_by, pipe = bound(
            case.ops, case.in_bytes + nbytes(*outs_k), exp_per_s())
        del out_k, out_p, outs_k, outs_p
        ms = cuda_ms(case.kern, 5)
        plain_ms = cuda_ms(case.plain, 2)
        library_ms = case.library() if case.library is not None else None
        lib = "" if library_ms is None else f", library call {library_ms:.3f} ms"
        print(f"{case.name}: rel L2 {rel:.3e}, max abs {mx:.3e} (per output "
              f"{[f'{e[0]:.2e}' for e in errs]}); kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms{lib}; bound {bound_ms:.4f} ms "
              f"({bound_by}: {pipe}), share {bound_ms / ms:.3f}", flush=True)
        check(ok_finite and rel <= REL_L2_TOL and abs_ok, (case.name, errs))
        rows.append(dict(name=case.name, route=case.route, source=case.source,
                         replaces=case.replaces, counter=case.counter,
                         max_abs_err=mx, rel_l2=rel, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms))
        torch.cuda.empty_cache()
    return rows


def random_tokenizer(vocab_size: int, seed: int):
    """Seeded random prompt ids of full length (the benchmark's prompts)."""
    rng = np.random.default_rng(seed)

    def tokenize(prompts, max_length):
        ids = rng.integers(0, vocab_size, (len(prompts), max_length))
        return {"input_ids": ids, "attention_mask": np.ones_like(ids)}

    return tokenize


def build_engine(device, arch, bert_config, text_len, *, use_kernels=True,
                 int8=False, state_dict=None, seed=0):
    """The zero-shot engine as served (fused LN+qkv), bf16 or int8."""
    from vit_exp_tpu_torch.eval.zero_shot import ZeroShotClassifier
    from vit_exp_tpu_torch.models.factory import build_ctclip

    model = build_ctclip(types.SimpleNamespace(**arch), bert_config,
                         device=device, use_kernels=use_kernels,
                         fuse_qkv=True, int8=int8, seed=seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    tok = random_tokenizer(bert_config.vocab_size, seed)
    return ZeroShotClassifier(model, tok, max_text_len=text_len)


def gate_volumes(base: torch.Tensor, seed: int) -> torch.Tensor:
    """A batch for the int8 accuracy check, as scripts/int8_accuracy_gate.py
    makes them: the base noise plus a separable low-frequency field (one
    random vector per slice, row and column) at a random amplitude, so the
    18 probabilities spread across volumes (a per-volume affine change
    would be removed by the first LayerNorm)."""
    g = torch.Generator(device=base.device).manual_seed(seed)
    b, _, t, hh, ww = base.shape

    def randn(*shape):
        return torch.randn(shape, generator=g, device=base.device)

    amp = 0.3 + 1.2 * torch.rand((b, 1, 1, 1, 1), generator=g,
                                 device=base.device)
    field = randn(b, 1, t, 1, 1) + randn(b, 1, 1, hh, 1) + randn(b, 1, 1, 1, ww)
    return (base.float() + amp * field).to(base.dtype)


def rank_auroc(scores: np.ndarray, labels: np.ndarray) -> float:
    """AUROC of scores against 0/1 labels (Mann-Whitney U, ties averaged)."""
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    _, inverse, counts = np.unique(scores, return_inverse=True,
                                   return_counts=True)
    ranks = (np.bincount(inverse, weights=ranks) / counts)[inverse]
    n1 = int(labels.sum())
    n0 = len(labels) - n1
    return float((ranks[labels == 1].sum() - n1 * (n1 + 1) / 2) / (n0 * n1))


def kendall_tau(a: np.ndarray, b: np.ndarray) -> float:
    """Kendall tau-a, as scripts/int8_accuracy_gate.py computes it."""
    da = np.sign(a[:, None] - a[None, :])
    db = np.sign(b[:, None] - b[None, :])
    iu = np.triu_indices(len(a), 1)
    return float(np.mean(da[iu] * db[iu]))


def int8_accuracy(eng8, eng, base, n_batches: int, seed: int = 100):
    """The first half of scripts/int8_accuracy_gate.py on the port: the int8
    engine against the bf16 engine over n_batches batches of gate volumes.
    Returns max and mean |Δprob| and, per label with a median split of the
    bf16 probabilities, the rank AUROC of the int8 ones and Kendall τ
    (printed, not bounded: at random weights the ranking is
    ill-conditioned)."""
    p8, pb = [], []
    for i in range(n_batches):
        vols = gate_volumes(base, seed + i)
        p8.append(eng8.predict_batch(vols))
        pb.append(eng.predict_batch(vols))
    p8, pb = np.concatenate(p8), np.concatenate(pb)
    aurocs, taus = [], []
    for c in range(pb.shape[1]):
        labels = (pb[:, c] > np.median(pb[:, c])).astype(int)
        if labels.min() == labels.max():
            continue
        aurocs.append(rank_auroc(p8[:, c], labels))
        taus.append(kendall_tau(pb[:, c], p8[:, c]))
    return dict(volumes=len(p8), dmax=float(np.abs(p8 - pb).max()),
                dmean=float(np.abs(p8 - pb).mean()),
                spread=float(np.std(pb, axis=0).mean()),
                finite=bool(np.isfinite(p8).all() and np.isfinite(pb).all()),
                auroc_min=min(aurocs, default=float("nan")),
                auroc_mean=float(np.mean(aurocs)) if aurocs else float("nan"),
                tau_min=min(taus, default=float("nan")),
                tau_mean=float(np.mean(taus)) if taus else float("nan"))


def build_trainer(device, arch, bert_config, *, use_kernels=True,
                  attn_impl="pallas_static", state_dict=None, seed=0):
    """(model, optimizer, image-report step) in the training configuration:
    unfused LN+qkv, bf16 compute, the trainer settings of bench.py --train;
    attn_impl "pallas_static" (K1, bench.py --train's) or "pallas" (K15,
    run_train's default)."""
    from vit_exp_tpu_torch.models.factory import build_ctclip
    from vit_exp_tpu_torch.train.optimizer import build_optimizer
    from vit_exp_tpu_torch.train.steps import make_train_steps

    model = build_ctclip(types.SimpleNamespace(**arch), bert_config,
                         device=device, use_kernels=use_kernels,
                         attn_impl=attn_impl, seed=seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model.train()
    opt = build_optimizer(types.SimpleNamespace(**TRAINER), model.parameters())
    config = types.SimpleNamespace(ct_clip_arch=types.SimpleNamespace(
        decoupled_contrastive_learning=False))
    return model, opt, make_train_steps(model, opt, config)["imagereport"]


def train_batch(device, arch, vocab_size, batch, text_len, seed=1):
    """Seeded random volumes (bf16, as bench.py feeds them) and full-length
    random ids."""
    g = torch.Generator(device=device).manual_seed(seed)
    video = torch.randn((batch, 1, arch["temporal_size"], arch["image_size"],
                         arch["image_size"]), generator=g, device=device)
    ids = torch.randint(0, vocab_size, (batch, text_len), generator=g,
                        device=device)
    return {"image": video.to(torch.bfloat16), "input_ids": ids,
            "attention_mask": torch.ones_like(ids)}


def step_grads(trainer, batch):
    """Take one step; returns (loss, pre-clip global grad norm, the names of
    the parameters given a nonzero gradient)."""
    model, opt, step = trainer
    loss = float(step(batch, 1.0)["loss"])
    return loss, float(opt.grad_norm), {
        n for n, p in model.named_parameters()
        if p.grad is not None and bool(p.grad.abs().max() > 0)}


@contextlib.contextmanager
def plain_backward():
    """Route the attention and GEGLU Functions' backward through the plain
    twins of the backward kernels; their forward keeps K1 and K2."""
    from vit_exp_tpu_torch.ops import geglu_ff
    from vit_exp_tpu_torch.ops import flash_attention as fa

    saved = fa.attention_bwd, geglu_ff.geglu_ff_bwd
    fa.attention_bwd = fa.attention_bwd_plain
    geglu_ff.geglu_ff_bwd = geglu_ff.geglu_ff_bwd_plain
    try:
        yield
    finally:
        fa.attention_bwd, geglu_ff.geglu_ff_bwd = saved


def tower_grads(model, video, seed=3):
    """The image tower's parameter gradients (fp32) for a seeded N(0, 1)
    cotangent on its output tokens, from one forward on the kernels: (through
    the backward kernels, through their plain twins).  One forward for both
    keeps the comparison well-conditioned: at random weights the q-side
    gradients of the deeper blocks hang on the forward's bf16 rounding (δ =
    rowsum(dO·O) is taken from the bf16 attention output, which K1 and its
    plain twin round differently), so separate forwards put them up to 86%
    apart (relative L2, at full width on an H100) with correct kernels."""
    params = dict(model.visual_transformer.named_parameters())
    tokens = model.encode_image_tokens(video)
    g = torch.Generator(device=tokens.device).manual_seed(seed)
    cot = torch.randn(tokens.shape, generator=g,
                      device=tokens.device).to(tokens.dtype)
    kern = torch.autograd.grad(tokens, list(params.values()), cot,
                               retain_graph=True)
    with plain_backward():
        plain = torch.autograd.grad(tokens, list(params.values()), cot)
    return ({n: t.float() for n, t in zip(params, kern)},
            {n: t.float() for n, t in zip(params, plain)})


def grad_errors(a: torch.Tensor, b: torch.Tensor):
    """(relative L2 error, cosine) of gradient a against reference b; the
    norms are clamped at 1e-30, not at cosine_similarity's 1e-8."""
    a, b = a.flatten().double(), b.flatten().double()
    na, nb = torch.linalg.vector_norm(a), torch.linalg.vector_norm(b)
    return (float(torch.linalg.vector_norm(a - b) / nb.clamp_min(1e-30)),
            float(a @ b / (na * nb).clamp_min(1e-30)))


def compare_train_steps(device, arch, bert_config, batch_size, text_len,
                        attn_impl="pallas_static"):
    """From one seeded state on one batch: the image tower's gradients for
    a seeded cotangent through the backward kernels and through their plain
    twins, then one step on the plain versions and one on the kernels (whose
    launches are counted).  Returns the numbers the checks read, the launch
    counts, the kernel trainer (stepped once) and the batch."""
    kern = build_trainer(device, arch, bert_config, attn_impl=attn_impl)
    plain = build_trainer(device, arch, bert_config, use_kernels=False,
                          attn_impl=attn_impl,
                          state_dict=kern[0].state_dict())
    batch = train_batch(device, arch, bert_config.vocab_size, batch_size,
                        text_len)
    gk, gp = tower_grads(kern[0], batch["image"])
    tower = {n: grad_errors(gk[n], gp[n]) for n in gp}
    del gk, gp
    lp, np_, sp = step_grads(plain, batch)
    del plain
    (lk, nk, sk), launches = count_launches(lambda: step_grads(kern, batch))
    return dict(
        loss_kernel=lk, loss_plain=lp, norm_kernel=nk, norm_plain=np_,
        tower=tower, missing=sorted(sp - sk),
        finite=all(bool(torch.isfinite(p).all())
                   for p in kern[0].parameters())), launches, kern, batch


def profile_call(fn, path: Path, what: str):
    """Device time by kernel of one warm call of fn (torch.profiler,
    CUPTI); the full table goes to ``path``, the top rows to stdout.
    Returns (wall ms, device busy ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side rows only: the CPU-op rows repeat their kernels' time, and
    # so do the device ranges of annotated regions (Optimizer.step)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e3   # ms
    lines = [f"{what}: wall {wall * 1e3:.3f} ms, device busy "
             f"{busy:.3f} ms, idle share {1 - busy / (wall * 1e3):.3f}"]
    lines += [f"{e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x  "
              f"{e.key[:110]}" for e in rows]
    path.write_text("\n".join(lines) + "\n")
    print("\n".join(lines[:16]), flush=True)
    return wall * 1e3, busy


def train_phase(device, bert_config, attn_impl: str, expected: dict,
                tag: str):
    """The contrastive train step at full width on the kernels against its
    plain twins (compare_train_steps), its checks, then 3 timed warm steps
    and one profiled.  Returns (launches of one step, steps/s, the step
    times, peak device memory in GB)."""
    torch.cuda.reset_peak_memory_stats()
    res, launches, kern, batch = compare_train_steps(
        device, ARCH, bert_config, BATCH, TEXT_LEN, attn_impl=attn_impl)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    print(f"launches in one train step ({attn_impl}): {launches} (expected "
          f"{expected})", flush=True)
    tower = res["tower"]
    (OUT_DIR / f"train_grads{tag}.txt").write_text(
        "image-tower gradients for a seeded cotangent, backward kernels vs "
        "plain twins: relative L2 error, cosine\n" + "\n".join(
            f"{n:64s} {e:.4e} {c:+.7f}" for n, (e, c) in tower.items()) + "\n")
    worst = max(tower, key=lambda n: tower[n][0])
    dloss = abs(res["loss_kernel"] - res["loss_plain"]) / abs(res["loss_plain"])
    dnorm = abs(res["norm_kernel"] - res["norm_plain"]) / res["norm_plain"]
    print(f"image-tower gradients ({attn_impl}), backward kernels vs plain "
          f"twins, {len(tower)} tensors: relative L2 max "
          f"{tower[worst][0]:.4e} ({worst}), tolerance {TOWER_GRAD_RTOL}; "
          f"cosine min {min(c for _, c in tower.values()):.7f}", flush=True)
    print(f"train step ({attn_impl}): loss kernels {res['loss_kernel']:.6f}, "
          f"plain {res['loss_plain']:.6f} (rel {dloss:.3e}, tolerance "
          f"{LOSS_RTOL}); grad norm kernels {res['norm_kernel']:.6f}, plain "
          f"{res['norm_plain']:.6f} (rel {dnorm:.3e}, tolerance "
          f"{GRAD_NORM_RTOL}); params without a kernel-path gradient: "
          f"{res['missing']}; peak device memory {peak_gb:.3f} GB", flush=True)
    check(launches == expected, launches)
    check(all(e <= TOWER_GRAD_RTOL for e, _ in tower.values()),
          (worst, tower[worst]))
    check(math.isfinite(res["loss_kernel"]) and math.isfinite(res["loss_plain"])
          and dloss <= LOSS_RTOL, res["loss_kernel"])
    check(not res["missing"] and res["finite"], res["missing"])
    check(dnorm <= GRAD_NORM_RTOL, dnorm)

    step = kern[2]
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        float(step(batch, 1.0)["loss"])
        times.append(time.perf_counter() - t0)
    profile_call(lambda: float(step(batch, 1.0)["loss"]),
                 OUT_DIR / f"profile_train{tag}.txt",
                 f"one train step ({attn_impl})")
    return launches, 1.0 / statistics.median(times), times, peak_gb


# configs/prod_sustained_synth.yaml: the flagship-width run of the trainer
# (full width, batch 4, lr 1.25e-6, wd 0.01)
RUN_TRAIN_CONFIG = ROOT / "configs" / "prod_sustained_synth.yaml"


def run_train_config(folder: Path, name: str, overrides=None) -> str:
    """RUN_TRAIN_CONFIG with its hook list dropped and its results folder
    moved to ``folder``/``name``; ``overrides`` replaces top-level keys (the
    CPU rehearsal's tiny arch).  Returns the written YAML's path."""
    import yaml

    cfg = yaml.safe_load(RUN_TRAIN_CONFIG.read_text())
    cfg.pop("valid_test_list", None)
    cfg["results_folder"] = str(folder / name)
    cfg.update(overrides or {})
    path = folder / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def state_equal(a, b) -> bool:
    """Bit-for-bit equality of two nested dicts/lists of tensors and
    values."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(state_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(map(state_equal, a, b)))
    return a == b


def trainer_state(trainer) -> dict:
    """A host copy of the trainer's weights, optimizer state and step."""
    from vit_exp_tpu_torch.train.checkpoint import to_host

    return to_host({"model": trainer.model.state_dict(),
                    "optimizer": trainer.optimizer.state_dict(),
                    "step": trainer.step})


def read_metrics(folder: Path) -> list:
    with open(folder / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def release(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def watch_steps(count_step: int):
    """While open, every CTClipTrainer's train_step notes (the step it
    starts, the host clock, the trainer's loader wait and batches so far)
    as it starts, and step ``count_step`` runs with every launch count set
    to 0 just before it and read just after.  Yields (the notes, the
    counts)."""
    from vit_exp_tpu_torch.train.trainer import CTClipTrainer

    marks, launches = [], {}
    inner = CTClipTrainer.train_step

    def train_step(self):
        marks.append((self.step + 1, time.perf_counter(), self.data_wait_s,
                      self.batches))
        if self.step + 1 != count_step:
            return inner(self)
        out, counts = count_launches(lambda: inner(self))
        launches.update(counts)
        return out

    CTClipTrainer.train_step = train_step
    try:
        yield marks, launches
    finally:
        CTClipTrainer.train_step = inner


def run_train_phase(device, folder: Path, overrides=None, synthetic=8,
                    throughput_samples=64, throughput_steps=12, skip=3):
    """``run_train.main`` at its default attn_impl="pallas" on the derived
    config: 2 steps; a trainer restored with --auto_resume, held bit for
    bit to the state the first run ended with; --auto_resume to 3 steps.
    Then, in a folder of its own, a run of ``throughput_steps`` steps over
    ``throughput_samples`` samples (one loader epoch at batch 4; the
    8-sample set restarts it every 2 steps), whose last step's launches
    are counted.  Its steps/s and loader wait per batch are taken over the
    same steps, from the start of step ``skip`` + 1 (past the first loader
    fill and the warm-up) to the start of the last step.  Returns (the
    numbers, the throughput run's trainer)."""
    from vit_exp_tpu_torch.cli import run_train

    cfg = run_train_config(folder, "run", overrides)
    base = ["--config", cfg, "--synthetic", str(synthetic), "--debug"]
    t1 = run_train.main(base + ["--steps", "2"], device=device)
    check(t1.status == "completed" and t1.step == 2
          and t1.ckpt.all_steps() == [2], (t1.status, t1.step))
    ckpt_gb = sum(f.stat().st_size for f in
                  (Path(t1.ckpt.directory) / "ckpt_2").iterdir()) / 1e9
    ended = trainer_state(t1)
    del t1
    release(device)
    restored = run_train.make_trainer(
        run_train.parse_args(base + ["--auto_resume"]), device)
    same = restored.step == 2 and state_equal(trainer_state(restored), ended)
    del restored, ended
    release(device)
    check(same, "a trainer restored from ckpt_2 differs from the state the "
                "first run saved")
    t2 = run_train.main(base + ["--auto_resume", "--steps", "3"],
                        device=device)
    lines = read_metrics(folder / "run")
    losses = [d["ds0_cl_loss"] for d in lines]
    check(t2.status == "completed" and t2.step == 3
          and t2.ckpt.all_steps() == [2, 3], (t2.status, t2.ckpt.all_steps()))
    check([d["step"] for d in lines] == [1, 2, 3]
          and all(math.isfinite(x) for x in losses), lines)
    del t2
    release(device)
    shutil.rmtree(folder / "run")

    cfg = run_train_config(folder, "throughput", overrides)
    with watch_steps(throughput_steps) as (marks, launches):
        tt = run_train.main(["--config", cfg, "--synthetic",
                             str(throughput_samples), "--debug", "--steps",
                             str(throughput_steps)], device=device)
    times = [d["step_time_s"] for d in read_metrics(folder / "throughput")]
    check(tt.status == "completed" and len(times) == throughput_steps
          and all(math.isfinite(t) for t in times), times)
    check([m[0] for m in marks] == list(range(1, throughput_steps + 1)),
          marks)
    window = marks[skip:]
    waits = [b[2] - a[2] for a, b in zip(window, window[1:])]
    (_, t_a, w_a, b_a), (_, t_b, w_b, b_b) = window[0], window[-1]
    loader = tt.loaders[0].loader
    t0 = time.perf_counter()
    loader.load_batch(list(range(loader.batch_size)))
    collate_s = time.perf_counter() - t0
    return dict(losses=losses, ckpt_gb=ckpt_gb, times=times,
                window=(skip + 1, throughput_steps - 1),
                sps=(len(window) - 1) / (t_b - t_a), waits=waits,
                wait_s=(w_b - w_a) / (b_b - b_a), collate_s=collate_s,
                launches=launches), tt


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    from vit_exp_tpu_torch.models.bert import BertConfig
    from vit_exp_tpu_torch.ops import _build

    # the plain reference side runs fp32 products in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    prebuilt = _build.library_path().exists()
    lib_path = _build.build()
    _build.lib()
    print(f"kernels {'loaded' if prebuilt else 'built'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    build_log = lib_path.with_suffix(".log").read_text()
    (OUT_DIR / "kernel_build.log").write_text(build_log)
    ptxas = ptxas_report(build_log, REPORTED_KERNELS)
    for name in REPORTED_KERNELS:
        regs, st, ld = ptxas.get(name, (None, None, None))
        print(f"ptxas {name}: {regs} registers, spill stores {st} bytes, "
              f"spill loads {ld} bytes", flush=True)
    check(set(ptxas) == set(REPORTED_KERNELS)
          and all(st == ld == 0 for _, st, ld in ptxas.values()),
          ("ptxas registers and spills", ptxas))

    rows = {}
    for phase, make in (("serve", kernel_cases),
                        ("train", training_kernel_cases),
                        ("int8", int8_kernel_cases),
                        ("online", online_kernel_cases)):
        cases = make(device)
        rows[phase] = compare_kernels(cases)
        del cases
        torch.cuda.empty_cache()
    print(pair_line(rows, card), flush=True)
    for line in forward_lines(rows, card):
        print(line, flush=True)

    # the bf16 serving path at full width
    bert = BertConfig()
    blocks = ARCH["transformer_blocks"]
    eng = build_engine(device, ARCH, bert, TEXT_LEN)
    text = eng.prepare()
    check(text.shape == (N_PROMPTS, 768) and bool(torch.isfinite(text).all()),
          ("prompt latents", tuple(text.shape)))
    g = torch.Generator(device=device).manual_seed(1)
    shape = (BATCH, 1, ARCH["temporal_size"], ARCH["image_size"],
             ARCH["image_size"])
    volumes = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    launches = {}
    probs, launches["serve"] = count_launches(
        lambda: eng.predict_batch(volumes))
    k2 = {"K2x": blocks, "K2h": blocks, "K2o": blocks}
    expected = expected_launches({"K1": blocks, **k2, "K3": blocks, "K4": 1})
    print(f"launches in one bf16 predict_batch: {launches['serve']} "
          f"(expected {expected})", flush=True)
    check(launches["serve"] == expected, launches["serve"])
    check(probs.shape == (BATCH, 18) and bool(np.isfinite(probs).all())
          and bool(((probs >= 0) & (probs <= 1)).all()), probs)

    ref = build_engine(device, ARCH, bert, TEXT_LEN, use_kernels=False,
                       state_dict=eng.model.state_dict())
    probs_ref = ref.predict_batch(volumes[:1])
    dprob = float(np.abs(probs[:1] - probs_ref).max())
    print(f"volume 0: max |prob(kernels) - prob(plain)| = {dprob:.3e} "
          f"(tolerance {PROB_TOL})", flush=True)
    check(dprob <= PROB_TOL, dprob)
    del ref
    torch.cuda.empty_cache()

    serve_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.predict_batch(volumes)
        serve_times.append(time.perf_counter() - t0)
    vps = BATCH / statistics.median(serve_times)
    profile_call(lambda: eng.predict_batch(volumes),
                 OUT_DIR / "profile_serving.txt", "one bf16 predict_batch")

    # the int8 serving path (the JAX package's serving default) at full
    # width, on the bf16 engine's weights
    eng8 = build_engine(device, ARCH, bert, TEXT_LEN, int8=True,
                        state_dict=eng.model.state_dict())
    eng8.prepare()
    probs8, launches["int8"] = count_launches(
        lambda: eng8.predict_batch(volumes))
    expected = expected_launches({"K4": 1, "K9/K10": blocks, "K11y": blocks,
                                  "K11h": blocks, "K11q": blocks,
                                  "K11o": blocks, "K12/K13": blocks,
                                  "K14": blocks})
    print(f"launches in one int8 predict_batch: {launches['int8']} "
          f"(expected {expected})", flush=True)
    check(launches["int8"] == expected, launches["int8"])
    check(probs8.shape == (BATCH, 18) and bool(np.isfinite(probs8).all())
          and bool(((probs8 >= 0) & (probs8 <= 1)).all()), probs8)
    ref8 = build_engine(device, ARCH, bert, TEXT_LEN, int8=True,
                        use_kernels=False, state_dict=eng.model.state_dict())
    dprob8 = float(np.abs(probs8[:1] - ref8.predict_batch(volumes[:1])).max())
    print(f"int8 volume 0: max |prob(kernels) - prob(plain)| = {dprob8:.3e} "
          f"(tolerance {PROB_TOL})", flush=True)
    check(dprob8 <= PROB_TOL, dprob8)
    del ref8
    torch.cuda.empty_cache()
    acc = int8_accuracy(eng8, eng, volumes, GATE_BATCHES)
    print(f"int8 vs bf16 over {acc['volumes']} volumes: max |Δprob| "
          f"{acc['dmax']:.5f} (tolerance {INT8_PROB_TOL}), mean "
          f"{acc['dmean']:.6f}; probability spread (mean per-label std) "
          f"{acc['spread']:.4f}; per-label rank AUROC min "
          f"{acc['auroc_min']:.4f} mean {acc['auroc_mean']:.4f}; Kendall "
          f"tau min {acc['tau_min']:.4f} mean {acc['tau_mean']:.4f} "
          f"(printed, not bounded)", flush=True)
    check(acc["finite"] and acc["dmax"] <= INT8_PROB_TOL, acc)

    int8_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng8.predict_batch(volumes)
        int8_times.append(time.perf_counter() - t0)
    vps8 = BATCH / statistics.median(int8_times)
    profile_call(lambda: eng8.predict_batch(volumes),
                 OUT_DIR / "profile_serving_int8.txt", "one int8 predict_batch")
    del eng, eng8, volumes
    torch.cuda.empty_cache()

    # the contrastive train step at full width, kernels against plain: in
    # bench.py --train's configuration (K1), then at run_train's default
    # attention (K15 over the concatenated kv)
    # per block K8 launches y, dh, dy and dx once, the weight GEMM twice
    # (dW1, dW2) and the ordered sum four times (dW1, dW2, dgamma, dbeta)
    common = {**k2, "K4": 1, "dKdV": blocks, "dQ": blocks,
              "K8y": blocks, "K8dh": blocks, "K8dy": blocks, "K8dx": blocks,
              "K8w": 2 * blocks, "K8sum": 4 * blocks}
    launches["train"], sps, train_times, peak_gb = train_phase(
        device, bert, "pallas_static",
        expected_launches({"K1": blocks, **common}), "")
    expected = expected_launches({"K15": blocks, **common})
    _, sps_p, train_times_p, peak_gb_p = train_phase(
        device, bert, "pallas", expected, "_pallas")

    # run_train end to end at full width: train, save, resume; the K15
    # rows take their launches from one step of its trainer loop
    torch.cuda.reset_peak_memory_stats()
    folder = Path(tempfile.mkdtemp(prefix="chip_smoke_run_train_"))
    try:
        rt, tt = run_train_phase(device, folder)
        launches["online"] = rt["launches"]
        print(f"launches in one run_train step: {launches['online']} "
              f"(expected {expected})", flush=True)
        check(launches["online"] == expected, launches["online"])
        wall_ms, busy_ms = profile_call(
            lambda: [float(v) for v in tt.train_step().values()],
            OUT_DIR / "profile_run_train.txt", "one run_train step")
        del tt
        release(device)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    rt_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"run_train: losses {rt['losses']}; ckpt_2 {rt['ckpt_gb']:.3f} GB; "
          f"resumed at step 2 bit for bit; throughput run step_time_s "
          f"{[round(t, 4) for t in rt['times']]} s; loader wait in steps "
          f"{rt['window'][0]}-{rt['window'][1]} "
          f"{[round(w, 4) for w in rt['waits']]} s", flush=True)

    kernels = []
    for phase in ("serve", "train", "int8", "online"):
        for row in rows[phase]:
            row["launches"] = launches[phase][row.pop("counter")]
            kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(f"zero-shot serving, batch {BATCH}, bf16: {vps:.3f} volumes/s "
          f"(median of 3 warm predict_batch calls, "
          f"{[round(t, 4) for t in serve_times]} s) on {card}")
    print(f"zero-shot serving, batch {BATCH}, int8: {vps8:.3f} volumes/s "
          f"(median of 3 warm predict_batch calls, "
          f"{[round(t, 4) for t in int8_times]} s) on {card}")
    print(f"contrastive train step, batch {BATCH}, bf16: {sps:.3f} steps/s "
          f"(median of 3 warm steps, {[round(t, 4) for t in train_times]} s; "
          f"peak device memory {peak_gb:.3f} GB) on {card}")
    print(f"contrastive train step, batch {BATCH}, bf16, attn_impl=pallas "
          f"(K15): {sps_p:.3f} steps/s (median of 3 warm steps, "
          f"{[round(t, 4) for t in train_times_p]} s; peak device memory "
          f"{peak_gb_p:.3f} GB) on {card}")
    print(f"run_train, batch {BATCH}, synthetic data, attn_impl=pallas: "
          f"{rt['sps']:.3f} steps/s and loader wait {rt['wait_s']:.3f} s "
          f"per batch, both over steps {rt['window'][0]}-{rt['window'][1]} "
          f"of a 64-sample run (wall time from the start of the first to the "
          f"start of the step after the last); one profiled step: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}; one batch collated on one thread "
          f"{rt['collate_s']:.3f} s; peak device memory {rt_peak_gb:.3f} GB "
          f"on {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
