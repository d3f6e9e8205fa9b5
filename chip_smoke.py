#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. Requires a CUDA device (exits non-zero without one) and prints the card's
   name and power limit as nvidia-smi reports them.
2. Builds the hand-written kernels from ``vit_exp_tpu_torch/csrc``.
3. Holds each kernel against its plain PyTorch version at the shapes of the
   serving and training paths (batch 4, 13,824 tokens, width 768; the
   training rows add K1's lse, the two attention backward kernels and
   K8's two phases, one row per launch counter), bf16
   inputs, relative L2 error ≤ REL_L2_TOL and max abs error ≤ MAX_ABS_TOL ·
   max|plain|, and times both with CUDA events.
4. Runs the zero-shot serving path at full width (fused LN+qkv, as served):
   CTViT3D (8 blocks) + BERT-base with seeded random weights, 36 prompts of
   512 tokens, 4 random volumes of (1, 240, 480, 480).  Checks finite
   (4, 18) probabilities in [0, 1], the launch counts of one
   ``predict_batch``, and that volume 0 agrees with the all-plain path on
   the card within PROB_TOL; times warm ``predict_batch`` calls, then
   profiles one more (device time by kernel and idle share, torch.profiler;
   the full table goes to chiprun_out/profile_serving.txt).
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
   chiprun_out/train_grads.txt).
6. Prints one JSON line with every kernel's numbers, the card line, the
   throughput lines, and last ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no "ok".
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

REL_L2_TOL = 1e-2   # bf16 outputs of the kernel vs fp32 plain arithmetic
# max abs error ≤ MAX_ABS_TOL · max|plain|: two bf16 ulps of the largest
# output (both sides round the same fp32 value up to summation order)
MAX_ABS_TOL = 2.0 ** -6
PROB_TOL = 0.02     # kernel path vs all-plain path, probabilities
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


def kernel_cases(device, arch=ARCH, batch=BATCH, seed=0):
    """Inputs of K1-K4 at the serving path's shapes, as (name, route,
    source, replaces, kernel_fn, plain_fn, counter) tuples; inputs are
    bf16; counter names the launch count the row reports."""
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
    bound = torch.tensor(scale, device=device)
    k1 = (qp, k, v, nk, nv, bound, scale)

    # K2 / K3: token matrix with its LN statistics
    x = randn(m, d)
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    w1p, w2 = randn(d, 2 * inner, std=d ** -0.5), randn(inner, d, std=inner ** -0.5)
    d1 = randn(2 * inner, std=0.1).float()
    wf = randn(d, 3 * h * dh, std=d ** -0.5)
    c = torch.cat([wf[:, :h * dh].float().sum(0),
                   torch.zeros(2 * h * dh, device=device)])

    # K4: the video as (b·t, c·pt, H, W)
    video = randn(batch * t, arch["channels"] * arch["temporal_patch_size"],
                  arch["image_size"], arch["image_size"])
    p = arch["patch_size"]

    return [
        ("K1 static-max attention", "cuda",
         "vit_exp_tpu_torch/csrc/flash_static.cu",
         "vit_exp_tpu/ops/flash_attention.py:78",
         lambda: fa.attention_static(*k1), lambda: fa.attention_static_plain(*k1),
         "K1"),
        ("K2 fused GEGLU feed-forward", "cuda",
         "vit_exp_tpu_torch/csrc/geglu_ff.cu", "vit_exp_tpu/ops/geglu_ff.py:63",
         lambda: geglu_ff.geglu_ff(x, mu, inv, w1p, d1, w2),
         lambda: geglu_ff.geglu_ff_plain(x, mu, inv, w1p, d1, w2), "K2"),
        ("K3 fused LN + qkv projection", "cuda",
         "vit_exp_tpu_torch/csrc/ln_qkv.cu", "vit_exp_tpu/ops/fused_proj.py:43",
         lambda: fused_proj.ln_qkv(x, mu, inv, wf, c, h * dh),
         lambda: fused_proj.ln_qkv_plain(x, mu, inv, wf, c, h * dh), "K3"),
        ("K4 patch statistics", "cuda",
         "vit_exp_tpu_torch/csrc/patch_stats.cu", "vit_exp_tpu/ops/patches.py:56",
         lambda: patches.patch_stats(video, p, p),
         lambda: patches.patch_stats_plain(video, p, p), "K4"),
    ]


def training_kernel_cases(device, arch=ARCH, batch=BATCH, seed=2):
    """The training path's kernel rows at its shapes, as kernel_cases gives
    them: K1 with lse, the two attention backward kernels (each against its
    outputs of the plain backward twin) and K8's two phases (both sides of
    the weight phase take the kernel token phase's y, dh and act)."""
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
    bound = torch.tensor(scale, device=device)
    fwd = (q, k, v, nk, nv, bound, scale)
    dout = heads(randn(batch, n, h * dh, std=1e-3).to(bf))
    out, lse = fa.attention_static_plain(*fwd, save_lse=True)
    delta = (dout.float() * out.float()).sum(-1)
    bwd = (q, k, v, dout, lse, delta, scale)
    del out

    x = randn(m, d).to(bf)
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    gamma, beta = 1 + 0.1 * randn(d), 0.1 * randn(d)
    w1, w2 = randn(d, 2 * inner, std=d ** -0.5), randn(inner, d,
                                                       std=inner ** -0.5)
    dout_ff = randn(m, d, std=1e-3).to(bf)
    ff = (x, mu, inv, gamma, beta, w1.to(bf), w2.to(bf), dout_ff)
    dx, dh, act, y, dgp, dbp = geglu_ff.geglu_ff_bwd_tokens(*ff)
    wgt = (y, dh, act, dout_ff, dgp, dbp)
    del dx
    flash_bwd = "vit_exp_tpu_torch/csrc/flash_bwd.cu"
    k5 = "vit_exp_tpu/ops/flash_attention.py:868"
    ff_bwd = "vit_exp_tpu_torch/csrc/geglu_ff_bwd.cu"
    k8 = "vit_exp_tpu/ops/geglu_ff.py:134"

    return [
        ("K1 static-max attention + lse (training)", "cuda",
         "vit_exp_tpu_torch/csrc/flash_static.cu",
         "vit_exp_tpu/ops/flash_attention.py:78",
         lambda: fa.attention_static(*fwd, save_lse=True),
         lambda: fa.attention_static_plain(*fwd, save_lse=True), "K1"),
        ("K5/K7 attention backward: dK/dV kernel", "cuda", flash_bwd, k5,
         lambda: fa.attention_bwd_dkv(*bwd),
         lambda: fa.attention_bwd_plain(*bwd)[1:], "dKdV"),
        ("K5/K6 attention backward: dQ kernel", "cuda", flash_bwd, k5,
         lambda: fa.attention_bwd_dq(*bwd),
         lambda: fa.attention_bwd_plain(*bwd)[0], "dQ"),
        ("K8 GEGLU backward: token phase (dx, dh, act, y)", "cuda", ff_bwd, k8,
         lambda: geglu_ff.geglu_ff_bwd_tokens(*ff)[:4],
         lambda: geglu_ff.geglu_ff_bwd_tokens_plain(*ff)[:4], "K8a"),
        ("K8 GEGLU backward: weight phase (dW1, dW2, dgamma, dbeta)", "cuda",
         ff_bwd, k8, lambda: geglu_ff.geglu_ff_bwd_weights(*wgt),
         lambda: geglu_ff.geglu_ff_bwd_weights_plain(*wgt), "K8b"),
    ]


def kernel_counters():
    from vit_exp_tpu_torch.ops import fused_proj, geglu_ff, patches
    from vit_exp_tpu_torch.ops import flash_attention as fa

    return {"K1": fa.attention_static, "K2": geglu_ff.geglu_ff,
            "K3": fused_proj.ln_qkv, "K4": patches.patch_stats,
            "dKdV": fa.attention_bwd_dkv, "dQ": fa.attention_bwd_dq,
            "K8a": geglu_ff.geglu_ff_bwd_tokens,
            "K8b": geglu_ff.geglu_ff_bwd_weights}


def count_launches(fn):
    """Run fn with every launch count set to 0 just before; return its
    result and the counts just after."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    return out, {k: c.launches for k, c in counters.items()}


def compare_kernels(cases):
    """Hold each case's kernel against its plain version and time both;
    returns the JSON rows (launches filled in later)."""
    rows = []
    for name, route, source, replaces, kern, plain, counter in cases:
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
        outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
        errs = [compare(a, b) for a, b in zip(outs_k, outs_p)]
        rel, mx = max(e[0] for e in errs), max(e[1] for e in errs)
        abs_ok = all(e[1] <= MAX_ABS_TOL * e[2] for e in errs)
        ok_finite = all(torch.isfinite(a).all().item() for a in outs_k)
        del out_k, out_p, outs_k, outs_p
        ms = cuda_ms(kern, 5)
        plain_ms = cuda_ms(plain, 2)
        print(f"{name}: rel L2 {rel:.3e}, max abs {mx:.3e} (per output "
              f"{[f'{e[0]:.2e}' for e in errs]}); kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms", flush=True)
        check(ok_finite and rel <= REL_L2_TOL and abs_ok, (name, errs))
        rows.append(dict(name=name, route=route, source=source,
                         replaces=replaces, counter=counter, max_abs_err=mx,
                         rel_l2=rel, ms=ms, plain_ms=plain_ms))
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
                 state_dict=None, seed=0):
    from vit_exp_tpu_torch.eval.zero_shot import ZeroShotClassifier
    from vit_exp_tpu_torch.models.factory import build_ctclip

    model = build_ctclip(types.SimpleNamespace(**arch), bert_config,
                         device=device, use_kernels=use_kernels,
                         fuse_qkv=True, seed=seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    tok = random_tokenizer(bert_config.vocab_size, seed)
    return ZeroShotClassifier(model, tok, max_text_len=text_len)


def build_trainer(device, arch, bert_config, *, use_kernels=True,
                  state_dict=None, seed=0):
    """(model, optimizer, image-report step) in the training configuration:
    unfused LN+qkv, bf16 compute, the trainer settings of bench.py --train."""
    from vit_exp_tpu_torch.models.factory import build_ctclip
    from vit_exp_tpu_torch.train.optimizer import build_optimizer
    from vit_exp_tpu_torch.train.steps import make_train_steps

    model = build_ctclip(types.SimpleNamespace(**arch), bert_config,
                         device=device, use_kernels=use_kernels, seed=seed)
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


def compare_train_steps(device, arch, bert_config, batch_size, text_len):
    """From one seeded state on one batch: the image tower's gradients for
    a seeded cotangent through the backward kernels and through their plain
    twins, then one step on the plain versions and one on the kernels (whose
    launches are counted).  Returns the numbers the checks read, the launch
    counts, the kernel trainer (stepped once) and the batch."""
    kern = build_trainer(device, arch, bert_config)
    plain = build_trainer(device, arch, bert_config, use_kernels=False,
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


def profile_call(fn, path: Path, what: str) -> None:
    """Device time by kernel of one warm call of fn (torch.profiler,
    CUPTI); the full table goes to ``path``, the top rows to stdout."""
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
    (OUT_DIR / "kernel_build.log").write_text(
        lib_path.with_suffix(".log").read_text())

    serving_cases = kernel_cases(device)
    serve_rows = compare_kernels(serving_cases)
    del serving_cases
    training_cases = training_kernel_cases(device)
    train_rows = compare_kernels(training_cases)
    del training_cases
    torch.cuda.empty_cache()

    # the serving path at full width
    bert = BertConfig()
    eng = build_engine(device, ARCH, bert, TEXT_LEN)
    text = eng.prepare()
    check(text.shape == (N_PROMPTS, 768) and bool(torch.isfinite(text).all()),
          ("prompt latents", tuple(text.shape)))
    g = torch.Generator(device=device).manual_seed(1)
    shape = (BATCH, 1, ARCH["temporal_size"], ARCH["image_size"],
             ARCH["image_size"])
    volumes = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    probs, serve_launches = count_launches(lambda: eng.predict_batch(volumes))
    blocks = ARCH["transformer_blocks"]
    expected = {"K1": blocks, "K2": blocks, "K3": blocks, "K4": 1, "dKdV": 0,
                "dQ": 0, "K8a": 0, "K8b": 0}
    print(f"launches in one predict_batch: {serve_launches} (expected "
          f"{expected})", flush=True)
    check(serve_launches == expected, serve_launches)
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
                 OUT_DIR / "profile_serving.txt", "one predict_batch")
    del eng, volumes
    torch.cuda.empty_cache()

    # the contrastive train step at full width, kernels against plain
    torch.cuda.reset_peak_memory_stats()
    res, train_launches, kern, batch = compare_train_steps(
        device, ARCH, bert, BATCH, TEXT_LEN)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    expected = {"K1": blocks, "K2": blocks, "K3": 0, "K4": 1, "dKdV": blocks,
                "dQ": blocks, "K8a": blocks, "K8b": blocks}
    print(f"launches in one train step: {train_launches} (expected "
          f"{expected})", flush=True)
    tower = res["tower"]
    (OUT_DIR / "train_grads.txt").write_text(
        "image-tower gradients for a seeded cotangent, backward kernels vs "
        "plain twins: relative L2 error, cosine\n" + "\n".join(
            f"{n:64s} {e:.4e} {c:+.7f}" for n, (e, c) in tower.items()) + "\n")
    worst = max(tower, key=lambda n: tower[n][0])
    dloss = abs(res["loss_kernel"] - res["loss_plain"]) / abs(res["loss_plain"])
    dnorm = abs(res["norm_kernel"] - res["norm_plain"]) / res["norm_plain"]
    print(f"image-tower gradients, backward kernels vs plain twins, "
          f"{len(tower)} tensors: "
          f"relative L2 max {tower[worst][0]:.4e} ({worst}), tolerance "
          f"{TOWER_GRAD_RTOL}; cosine min "
          f"{min(c for _, c in tower.values()):.7f}", flush=True)
    print(f"train step: loss kernels {res['loss_kernel']:.6f}, plain "
          f"{res['loss_plain']:.6f} (rel {dloss:.3e}, tolerance {LOSS_RTOL}); "
          f"grad norm kernels {res['norm_kernel']:.6f}, plain "
          f"{res['norm_plain']:.6f} (rel {dnorm:.3e}, tolerance "
          f"{GRAD_NORM_RTOL}); params without a kernel-path gradient: "
          f"{res['missing']}; peak device memory {peak_gb:.3f} GB", flush=True)
    check(train_launches == expected, train_launches)
    check(all(e <= TOWER_GRAD_RTOL for e, _ in tower.values()),
          (worst, tower[worst]))
    check(math.isfinite(res["loss_kernel"]) and math.isfinite(res["loss_plain"])
          and dloss <= LOSS_RTOL, res["loss_kernel"])
    check(not res["missing"] and res["finite"], res["missing"])
    check(dnorm <= GRAD_NORM_RTOL, dnorm)

    step = kern[2]
    train_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        float(step(batch, 1.0)["loss"])
        train_times.append(time.perf_counter() - t0)
    sps = 1.0 / statistics.median(train_times)
    profile_call(lambda: float(step(batch, 1.0)["loss"]),
                 OUT_DIR / "profile_train.txt", "one train step")

    for rows, counts in ((serve_rows, serve_launches),
                         (train_rows, train_launches)):
        for row in rows:
            row["launches"] = counts[row.pop("counter")]
    print(json.dumps({"kernels": serve_rows + train_rows}))
    print(card)
    print(f"zero-shot serving, batch {BATCH}, bf16: {vps:.3f} volumes/s "
          f"(median of 3 warm predict_batch calls, "
          f"{[round(t, 4) for t in serve_times]} s) on {card}")
    print(f"contrastive train step, batch {BATCH}, bf16: {sps:.3f} steps/s "
          f"(median of 3 warm steps, {[round(t, 4) for t in train_times]} s) "
          f"on {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
