#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. Requires a CUDA device (exits non-zero without one) and prints the card's
   name and power limit as nvidia-smi reports them.
2. Builds the hand-written kernels from ``vit_exp_tpu_torch/csrc``.
3. Holds each kernel against its plain PyTorch version at the shapes of the
   serving path (batch 4, 13,824 tokens, width 768), bf16 inputs, relative
   L2 error ≤ REL_L2_TOL and max abs error ≤ MAX_ABS_TOL · max|plain|, and
   times both with CUDA events.
4. Runs the zero-shot serving path at full width: CTViT3D (8 blocks) + BERT-
   base with seeded random weights, 36 prompts of 512 tokens, 4 random
   volumes of (1, 240, 480, 480).  Checks finite (4, 18) probabilities in
   [0, 1], that each kernel's launch count rose as the path requires, and
   that volume 0 agrees with the all-plain path on the card within
   PROB_TOL; times warm ``predict_batch`` calls, then profiles one more
   (device time by kernel and idle share, torch.profiler; the full table
   goes to chiprun_out/profile_serving.txt).
5. Prints one JSON line with every kernel's numbers, the card line, the
   throughput line, and last ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no "ok".
"""

from __future__ import annotations

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
ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# production serving shape (bench.py's zero-shot program)
ARCH = dict(dim=768, image_size=480, patch_size=20, temporal_size=240,
            temporal_patch_size=10, transformer_blocks=8, dim_head=32,
            heads=8, channels=1, use_flash_attention=True)
BATCH, TEXT_LEN, N_PROMPTS = 4, 512, 36


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
    source, replaces, kernel_fn, plain_fn) tuples; inputs are bf16."""
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
         lambda: fa.attention_static(*k1), lambda: fa.attention_static_plain(*k1)),
        ("K2 fused GEGLU feed-forward", "cuda",
         "vit_exp_tpu_torch/csrc/geglu_ff.cu", "vit_exp_tpu/ops/geglu_ff.py:63",
         lambda: geglu_ff.geglu_ff(x, mu, inv, w1p, d1, w2),
         lambda: geglu_ff.geglu_ff_plain(x, mu, inv, w1p, d1, w2)),
        ("K3 fused LN + qkv projection", "cuda",
         "vit_exp_tpu_torch/csrc/ln_qkv.cu", "vit_exp_tpu/ops/fused_proj.py:43",
         lambda: fused_proj.ln_qkv(x, mu, inv, wf, c, h * dh),
         lambda: fused_proj.ln_qkv_plain(x, mu, inv, wf, c, h * dh)),
        ("K4 patch statistics", "cuda",
         "vit_exp_tpu_torch/csrc/patch_stats.cu", "vit_exp_tpu/ops/patches.py:56",
         lambda: patches.patch_stats(video, p, p),
         lambda: patches.patch_stats_plain(video, p, p)),
    ]


def kernel_counters():
    from vit_exp_tpu_torch.ops import fused_proj, geglu_ff, patches
    from vit_exp_tpu_torch.ops import flash_attention as fa

    return {"K1": fa.attention_static, "K2": geglu_ff.geglu_ff,
            "K3": fused_proj.ln_qkv, "K4": patches.patch_stats}


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
                         device=device, use_kernels=use_kernels, seed=seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    tok = random_tokenizer(bert_config.vocab_size, seed)
    return ZeroShotClassifier(model, tok, max_text_len=text_len)


def profile_serving(eng, volumes, path: Path) -> None:
    """Device time by kernel of one warm predict_batch (torch.profiler,
    CUPTI); the full table goes to ``path``, the top rows to stdout."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.predict_batch(volumes)
        wall = time.perf_counter() - t0
    # device-side rows only: the CPU-op rows repeat their kernels' time
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e3   # ms
    lines = [f"one predict_batch: wall {wall * 1e3:.3f} ms, device busy "
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

    rows = []
    for name, route, source, replaces, kern, plain in kernel_cases(device):
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
        print(f"{name}: rel L2 {rel:.3e}, max abs {mx:.3e}; "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
        check(ok_finite and rel <= REL_L2_TOL and abs_ok, (name, errs))
        rows.append(dict(name=name, route=route, source=source,
                         replaces=replaces, max_abs_err=mx, rel_l2=rel,
                         ms=ms, plain_ms=plain_ms))
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

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    probs = eng.predict_batch(volumes)
    launches = {k: fn.launches for k, fn in counters.items()}
    expected = {"K1": ARCH["transformer_blocks"], "K2": ARCH["transformer_blocks"],
                "K3": ARCH["transformer_blocks"], "K4": 1}
    print(f"launches in one predict_batch: {launches} (expected {expected})",
          flush=True)
    check(launches == expected, launches)
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

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.predict_batch(volumes)
        times.append(time.perf_counter() - t0)
    vps = BATCH / statistics.median(times)
    profile_serving(eng, volumes, OUT_DIR / "profile_serving.txt")

    for row in rows:
        row["launches"] = launches[row["name"][:2]]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(f"zero-shot serving, batch {BATCH}, bf16: {vps:.3f} volumes/s "
          f"(median of {len(times)} warm predict_batch calls, "
          f"{[round(t, 4) for t in times]} s) on {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
