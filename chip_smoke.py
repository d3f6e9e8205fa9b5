#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. Requires a CUDA device (exits non-zero without one) and prints the card's
   name and power limit as nvidia-smi reports them.
2. Builds the hand-written kernels from ``vit_exp_tpu_torch/csrc`` and
   prints ptxas's registers and spills for the GEMM kernels (K2's, K3's,
   K8's, K11's and K12/K13's products and K14 on gemm_wgmma.cuh, K11's,
   K12/K13's and K14 in its int8 form), the patch embedding (on
   gemm_mma.cuh) and the int8 attention (none may spill).
3. Holds each kernel against its plain PyTorch version at the shapes of the
   serving, training, int8 serving and run_train paths (batch 4, 13,824
   tokens, width 768; one row per launch counter: K1, K2's three kernels
   (x̂, act, out), K3, the fused patch embedding (K4 with the strided
   product and the LayerNorm fix-up; its μ and Σx² also against
   patch_stats_plain within PATCH_STATS_RTOL), K1 with lse, the
   two attention backward kernels, K8's six kernels (y, dh/act, dy, dx,
   the weight GEMM, the ordered sums), the int8 attention (K9/K10), K11's
   four kernels (y8, act, a8, out), K12/K13's two (x8, the product),
   K14, and K15 with and without lse and the two attention
   backward kernels over the 13,826 keys of the nulls concatenated to
   k/v), relative L2 error ≤ REL_L2_TOL and max abs error ≤
   MAX_ABS_TOL · max|plain| (K12/K13's stages and K14: bit for bit), and times
   both with CUDA events.  Each row also
   carries its bound (the least time an H100 could take: the largest of
   its bytes over the memory rate, its tensor-core and CUDA-core
   operations over the peak rates of their types, and, for the attention
   rows, its exps over the special-function units' rate, 16 per clock per
   SM at the SM clock nvidia-smi reports as clocks.max.sm) and, for K1,
   K15 and the attention backward pair, the time of torch's
   scaled_dot_product_attention on the same inputs (a yardstick, never on
   the path; its backward is timed once per input set and shared by the
   pair's two rows), for K8's weight GEMM torch.mm's, for the products
   of K2, K8's dh (two calls) and dy, K3, K11, K12/K13 and K14 torch.mm's
   and torch._int_mm's, and for
   the patch embedding F.conv2d on bf16 operands and torch.mm over a
   pre-built patch matrix (the products only, not the same function).
   Checks that K1
   (with lse, 13,824 keys), K15 (with lse, 13,826 keys), the backward pair
   (13,826 keys), K2, K8 (both phases), the int8 attention, K11,
   K12/K13 and the patch embedding each give the same bits twice (no
   atomics), prints K2's, K11's
   and K12/K13's times as a whole, each forward's times against
   SDPA's forward and the pair's summed time against the one SDPA
   backward.
4. Runs the zero-shot serving path at full width (fused LN+qkv, as served):
   CTViT3D (8 blocks) + BERT-base with seeded random weights, 36 prompts of
   512 tokens, 4 random volumes of (1, 240, 480, 480), first in bf16, then
   int8 (W8A8, the JAX package's serving default) on the same weights.
   Checks finite (4, 18) probabilities in [0, 1], the launch counts of one
   ``predict_batch``, and that volume 0 agrees with the all-plain path on
   the card within PROB_TOL; for int8 also the int8 accuracy gate
   (scripts/int8_accuracy_gate_torch.py, the JAX script's program):
   against the bf16 engine over GATE_BATCHES batches of 4 volumes (200)
   with a separable random field on the base noise GATE_BASE_SEEDS (the
   serving volumes' draw), max |Δprob| ≤ INT8_PROB_TOL and the min
   per-label rank AUROC ≥ INT8_MIN_RANK_AUROC (Kendall τ and the lowest
   labels printed; the bounds are held at the end of the run, after every
   later phase has run and printed); the same statistics on the base
   noises WITNESS_BASE_SEEDS are printed, not bounded.
   Times warm ``predict_batch`` calls, then
   profiles one more (device time by kernel and idle share,
   torch.profiler; the full tables go to chiprun_out/profile_serving.txt
   and profile_serving_int8.txt).
5. Runs the contrastive image-report train step at full width in the
   configuration of ``bench.py --train`` (batch 4, BERT-base at 512 tokens,
   lr 1e-5, max_grad_norm 0.5, Adam; unfused LN+qkv).  From one seeded
   state on one batch: the image tower's gradients for a seeded random
   cotangent on its output tokens, from one forward on the kernels, through
   the backward kernels and through their plain twins, each tensor within
   relative L2 TOWER_GRAD_RTOL, and the patch embedding's γ, β, W and b
   for a seeded cotangent through the kernel's forward and through its
   plain twin, within the same bound; then one step on the plain versions and
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
   the peak device memory.  Then the real-format data paths, on the first
   run's ckpt_2 and ckpt_3: the offline preprocessing of a 512 × 512 × 300
   int16 volume on the card against the CPU (relative L2 ≤ PREP_RTOL, both
   timed) and ``preprocess_ctrate.main`` on two written NIfTI files with
   and without --device (the npz within PREP_RTOL); 8 npz volumes in
   CT-RATE's tree (each crops or pads on some axis), a reports CSV and an
   18-column labels CSV with an empty cell each, packed to float16 by
   ``pack_dataset.main``; the native reader built, its get_batch
   byte-equal to the memmap slices, its rate; ``run_zero_shot_cls.main``
   over the tree (int8) and the store (int8, --no-int8), and as a sweep of
   the two checkpoints, each run's launches the serving path's per batch
   times its batches, npz against store within PROB_TOL, the sweep's
   second checkpoint bit for bit the fresh run's; then ``serve``'s server
   in-process on port 0 (int8, ckpt_3, warmed at batch 1 and 4): /health,
   8 concurrent clients × 2 /classify_path requests under --data_root
   (the largest batch 4, every probability bit for bit predict_batch's
   on the batch it was dispatched in and within PROB_TOL of it on its
   volume alone, each dispatch the int8 path's launches), a lone request's latency, one base64 /classify and one
   /embed (l2-normalised, dim_latent entries), and a batch's copy, tower
   and read-back times.  Then real-format training (the host's MemTotal
   printed): a CT-RATE tree again, a RadGenome tree (RADGENOME_N cases of
   (240, 480, 480) float32 images and 22-class uint8 masks, compressed,
   with a label table) and a float16 store from
   scripts/make_synth_shards_torch.py; ``run_train.main`` for
   REAL_TRAIN_STEPS optimizer steps on copies of
   configs/ct_clip_vit_open_seg.yaml, ct_clip_vit_seg.yaml (their
   acc_steps_list [4, 1] of micro-steps a step, num_workers as the
   configs say) and prod_sustained_synth.yaml whose data paths point at
   those files: finite losses at every step, the launches of each step
   type in the last step, the first REAL_TRAIN_CHECKED device batches of
   each loader (copied on the side stream while the card ran the step
   before) byte for byte the data set's batch of the same indices,
   steps/s and loader wait, one profiled step
   (chiprun_out/profile_real_*.txt), a batch of each type copied through
   a page-locked buffer and the side-stream copier against a pageable
   ``.to()`` of the same bytes, and the final checkpoint reloaded bit for
   bit; ``run_zero_shot_seg.main`` (int8) on the RadGenome folders with
   the seg run's checkpoint, its dice bit for bit its engine's on the
   same arrays in memory; ``run_latents.main`` (int8) on the CT-RATE tree
   with the packed run's checkpoint, its image latents bit for bit the
   engine's own encoders on the same batches, recall@k printed.
7. The segmentation paths at full width, each with the kernel rows of its
   own shapes (K15 with lse, the pair, K2, the patch embedding and K8 at
   batch 1; the serving kernels at one volume): the seg train step
   (configs/ct_clip_vit_seg.yaml: a seg head of mid 1024 and out 22, so
   88,000 features a token), the open-seg step
   (configs/ct_clip_vit_open_seg.yaml: clip_focal_loss, down factor 4, 4
   prompts through BERT-base) and its fusion arm
   (configs/ct_clip_vit_open_seg_fusion_single_cls.yaml, 6 prompts for its
   choose_cls [5]), at batch 1 and attn_impl="pallas", on a batch made on
   the device from a seeded generator (mask = rand > 0.8).  From one
   seeded state: the forward's outputs (the seg logits, the open-seg
   embeddings) within REL_L2_TOL of the plain path, the loss within
   LOSS_RTOL, the global gradient norm within GRAD_NORM_RTOL, every
   parameter plain gives a gradient gets one from the kernels, and the
   launch counts of one step; prints the warm step time, the peak device
   memory, one profiled step (chiprun_out/profile_{seg,open_seg,
   open_seg_fusion}.txt) and the head's and the loss's device time.
8. ``run_zero_shot_seg.main`` on --synthetic 2 with the seg config at
   random weights, at its int8 default and with --no-int8: finite
   per-class dice and the launch counts of one call; volume 0's logits
   against the all-plain engine of the same mode within REL_L2_TOL; warm
   dice calls of one volume timed (volumes/s) and profiled
   (chiprun_out/profile_seg_serving_{int8,bf16}.txt); the int8 logits'
   relative L2 against bf16's printed, not bounded.
9. ``run_train.main`` on configs/planted_mixed.yaml as is (dim 384, three
   loaders, the Combined sampler, both hooks) for 12 steps, the hooks
   every 6 in a temporary copy: finite cl_loss, seg_loss and
   open_seg_loss lines from all three loaders at every step, the seg
   hook's finite mean_dice and the cls hook's mean_auc at steps 6 and 12,
   and the launches of each step type in step 9; steps/s, loader wait and
   one profiled step (chiprun_out/profile_planted_mixed.txt).
10. The auxiliary training branches (the SSL heads, the fine-tuners and
   the report classifier), each checked on the card: the image-report step
   with the MLM and visual-SSL terms (simsiam, then simclr; batch 4,
   BERT-base at 512 tokens, attn_impl="pallas", the terms' default
   weights), from one seeded state on one batch with step 0's draws fixed,
   one step on plain and one on the kernels: the loss and each term
   within LOSS_RTOL of plain (relative above 1, absolute below: the
   SimSiam term is a cosine near 0), the global gradient norm within
   GRAD_NORM_RTOL, every parameter plain gives a gradient gets one (the
   SSL heads and mlm_head among them), and the launches of three towers'
   train steps; warm steps/s, the peak device memory and one profiled
   simsiam step (chiprun_out/profile_ssl.txt).  ``run_train.main`` on an
   SSL copy of prod_sustained_synth: 2 steps, a restore held bit for bit
   (the optimizer's micro-step count, from which the draws come,
   included), --auto_resume to 3 with step 3's launches counted.
   ``run_finetune.main`` lipro on --synthetic 8 (batch 2): train, save
   the head, the launches of one fit_batch, a fresh probe's loss on one
   batch without dropout falling over 20 steps, its latents bit for bit
   the zero-shot engine's encoder on the same batch, --infer with its
   artifacts and launches (the rows of K15 without lse, K2 and the patch
   embedding at batch 2); volumes/s.  One VocabFine step (one volume, 36
   prompts of 512 tokens) on the kernels against plain from one state,
   as for the SSL step; steps/s and peak memory; ``run_finetune.main``
   vocabfine on --synthetic 2 with --save_path, and
   ``run_zero_shot_cls.main --torch_ckpt`` on the export over 4 synthetic
   volumes: finite probabilities, the int8 serving launches of one batch.
   ``run_text_classifier.main`` train (one epoch, batch 32, 512 tokens)
   and infer on 256 generated reports: finite losses, the checkpoint, the
   CSV; reports/s.
11. Sequence and data parallelism (phases "ring" and "nccl", each printing
   its seconds): ring attention at full width in one process, q/k/v (4, 8,
   13,824, 32) bf16 and the 2 null kv in 4 shards of 3,456 tokens, each
   rank's arithmetic in turn (``ring_by_rank``: K15 with lse per chunk,
   the lse merge, the null merge), forward and backward, its launches (16
   K15, 16 backward pairs) and its output and five gradients within
   REL_L2_TOL of full-sequence K15 over the concatenated nulls and of the
   plain ring, both timed, and the chunk kernels' rows (K15 with lse, the
   pair with a nonzero lse cotangent) at 3,456 × 3,456; then
   ``run_train.main`` at full width for NCCL_STEPS steps without and with
   the multi-host flags (an NCCL group of one rank on this card), the
   losses within NCCL_LOSS_RTOL, both step rates (from step
   NCCL_RATE_FROM), the last step's launches.
12. Tensor parallelism and one server over the grid (phases "tp_by_rank"
   and "serve_mesh"): one full-width tower block (attn_impl="pallas",
   13,824 tokens) forward and backward for a seeded cotangent, whole and
   as the model-2 and model-4 ranks' slices in one process
   (``tp_by_rank``: each rank's heads and GEGLU units, the partial
   outputs summed in fp32), on the kernels: output, dx and every
   parameter gradient within TP_REL_TOL of the whole block, each rank's
   K15, pair, K2 and K8 launched once, both timed, and the slices' kernel
   rows (K15 with lse, the pair, K2's three, K8's six at 4 and 2 heads,
   2I 2,048 and 1,024); then ``serve --mesh 1,1,1`` against the flagless
   server on the same requests, bit for bit.
13. The legacy generative stack at GenerateCT's published shapes (phase
   "generative", plain torch as the JAX package runs it: no kernel, so no
   kernel row): CTViTTrainer for GEN_STEPS steps on a (1, 1, 201, 128,
   128) volume (the VGG perceptual term, λ, the discriminator at steps 2,
   5 and 8 with the gradient penalty at 8), each loss term printed and
   finite, steps/s and peak memory; the fp32 encode → quantize → decode of
   17 frames on the card against the CPU (encoded tokens and the decode of
   the CPU's indices within GEN_CPU_RTOL, the agreeing indices printed);
   one MaskGITTrainer.fit_batch and one MaskGITTransformer.sample (18
   steps, cond_scale 5) on BERT-base's states of a padded prompt: ids in
   range, the decoded volume finite at (1, 1, 201, 128, 128), the sampling
   time; ``run_ctvit_recon.main`` on one synthetic volume.
14. Prints one JSON line with every kernel's numbers (the rows of 7-12 once
   for each path, with that path's launches), the card line, the
   throughput lines, and last ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no "ok".
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
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

# the int8 accuracy gate (scripts/int8_accuracy_gate_torch.py) and the
# serving engine it builds
# (its rank statistics too, which tests/test_torch_slice.py holds here)
from vit_exp_tpu_torch.eval.int8_gate import (GATE_BASE_SEEDS,
                                              WITNESS_BASE_SEEDS,
                                              build_engine, gate,
                                              gate_verdict, int8_accuracy,
                                              kendall_tau, lowest_labels,
                                              random_tokenizer, rank_auroc,
                                              report)

REL_L2_TOL = 1e-2   # bf16 outputs of the kernel vs fp32 plain arithmetic
# max abs error ≤ MAX_ABS_TOL · max|plain|: two bf16 ulps of the largest
# output (both sides round the same fp32 value up to summation order)
MAX_ABS_TOL = 2.0 ** -6
# the patch embedding's μ and Σx² vs patch_stats_plain, relative L2 (fp32
# sums of the same values in another order)
PATCH_STATS_RTOL = 1e-5
PROB_TOL = 0.02     # kernel path vs all-plain path, probabilities
# int8 engine vs bf16 engine on the same weights over GATE_BATCHES batches
# of 4 (200 volumes) on the base noise GATE_BASE_SEEDS: max |Δprob| and the
# min per-label rank AUROC (scripts/int8_accuracy_gate_torch.py's two
# bounds, the JAX script's); WITNESS_BASE_SEEDS are read and printed
INT8_PROB_TOL = 0.02
INT8_MIN_RANK_AUROC = 0.995
GATE_BATCHES = 50
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
    """Mean device time of fn() over iters launches, after one warm-up.
    The start event follows the warm-up on the stream without a host
    synchronisation, so the host's work for the first timed launch
    overlaps the warm-up on the device and is not counted as device time
    (a wrapper whose host work outlasts its kernel is still timed at its
    own rate)."""
    fn()
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
    exact: bool = False   # the kernel must give its twin's bits
    # further yardsticks: row key → timer (printed and kept in the row)
    extra: dict = dataclasses.field(default_factory=dict)


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


def patch_embed_inputs(device, g, arch=ARCH, batch=BATCH):
    """The fused patch embedding's inputs at the model's shapes: the video
    (b·t, c·pt, H, W) bf16, kc (D, n) bf16, csum and dvec (D,) fp32, p1,
    p2 and eps, from seeded LayerNorm and Linear weights."""
    c, pt, p = arch["channels"], arch["temporal_patch_size"], \
        arch["patch_size"]
    t, s, d = arch["temporal_size"] // pt, arch["image_size"], arch["dim"]
    n = c * pt * p * p
    video = torch.randn(batch * t, c * pt, s, s, generator=g,
                        device=device).to(torch.bfloat16)
    gamma = 1 + 0.1 * torch.randn(n, generator=g, device=device)
    beta = 0.1 * torch.randn(n, generator=g, device=device)
    w = torch.randn(n, d, generator=g, device=device) / math.sqrt(n)
    bias = 0.1 * torch.randn(d, generator=g, device=device)
    kf = w * gamma[:, None]
    return (video, kf.t().to(torch.bfloat16), kf.sum(0), beta @ w + bias, p,
            p, 1e-5)


def check_patch_stats(pe) -> None:
    """The patch embedding gives the same bits twice, and its μ and Σx²
    equal patch_stats_plain's within PATCH_STATS_RTOL (relative L2)."""
    from vit_exp_tpu_torch.ops import patches

    same_bits_twice(lambda: patches.patch_embed(*pe),
                    "patch embedding: tokens, μ and Σx²")
    _, mu, sq = patches.patch_embed(*pe)
    mu_p, sq_p = patches.patch_stats_plain(pe[0], pe[4], pe[5])
    errs = [compare(a, b)[0] for a, b in ((mu, mu_p), (sq, sq_p))]
    print(f"patch embedding statistics against patch_stats_plain: μ rel L2 "
          f"{errs[0]:.3e}, Σx² rel L2 {errs[1]:.3e} (tolerance "
          f"{PATCH_STATS_RTOL})", flush=True)
    check(all(e <= PATCH_STATS_RTOL for e in errs), ("patch statistics", errs))


def patch_embed_case(pe) -> "Case":
    """The fused patch embedding's row: one kernel against its plain twin
    (patch_stats_plain, F.conv2d in fp32 with TF32 off, the fp32 fix-ups),
    bound by its bf16 products; yardsticks of the product alone: F.conv2d
    on bf16 operands (library_ms) and torch.mm over a pre-built patch
    matrix (printed, and kept as library_mm_ms)."""
    import torch.nn.functional as F
    from vit_exp_tpu_torch.ops import patches

    video, kc, csum, dvec, p1, p2, eps = pe
    bt, cpt, h, w = video.shape
    m, (d, n) = bt * (h // p1) * (w // p2), kc.shape
    kc4 = kc.reshape(d, cpt, p1, p2)

    def mm_yardstick():
        a = video.reshape(bt, cpt, h // p1, p1, w // p2, p2).permute(
            0, 2, 4, 1, 3, 5).reshape(m, n)
        b = kc.t()
        ms = product_timer("the patch embedding: torch.mm over a pre-built "
                           f"({m} × {n}) patch matrix and kcᵀ",
                           lambda: torch.mm(a, b))()
        print(f"patch embedding yardstick torch.mm (the product only): "
              f"{ms:.3f} ms", flush=True)
        return ms

    return Case("K4 + patch-embed product: fused patch embedding "
                "(statistics, the strided product on the tensor cores, the "
                "LayerNorm fix-up in the epilogue)", "cuda",
                "vit_exp_tpu_torch/csrc/patch_embed.cu",
                "vit_exp_tpu/ops/patches.py:56",
                lambda: patches.patch_embed(*pe),
                lambda: patches.patch_embed_plain(*pe), "K4",
                {"bf16": 2 * m * n * d}, nbytes(video, kc, csum, dvec),
                product_timer("the patch embedding: F.conv2d on bf16 "
                              "operands", lambda: F.conv2d(
                                  video, kc4, stride=(p1, p2))),
                extra={"library_mm_ms": mm_yardstick})


def kernel_cases(device, arch=ARCH, batch=BATCH, seed=0):
    """K1-K3 and the patch embedding (K4 fused with the strided product) at
    the serving path's shapes, as Cases; inputs are bf16."""
    from vit_exp_tpu_torch.ops import fused_proj, geglu_ff
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

    same_bits_twice(lambda: (fused_proj.ln_qkv(x, mu, inv, wf, c, h * dh),),
                    f"K3 over {m} tokens")
    # K2's stages take the kernel chain's inputs
    k2 = (x, mu, inv, w1p, d1, w2)
    whole_kernel(lambda: (geglu_ff.geglu_ff(*k2),),
                 f"K2 over {m} tokens (x̂, act, out)", device)
    xn = geglu_ff.geglu_ff_x(x, mu, inv)
    act = geglu_ff.geglu_ff_h(xn, w1p, d1)
    ff = "vit_exp_tpu_torch/csrc/geglu_ff.cu"
    k2_src = "vit_exp_tpu/ops/geglu_ff.py:63"

    # the patch embedding (K4 fused with the strided product and the
    # fix-up): the video as (b·t, c·pt, H, W), the weights as
    # fused_patch_embed prepares them
    pe = patch_embed_inputs(device, g, arch, batch)
    check_patch_stats(pe)

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
        Case("K3 fused LN + qkv projection (the LayerNorm correction in the "
             "epilogue)", "cuda", "vit_exp_tpu_torch/csrc/ln_qkv.cu",
             "vit_exp_tpu/ops/fused_proj.py:43",
             lambda: fused_proj.ln_qkv(x, mu, inv, wf, c, h * dh),
             lambda: fused_proj.ln_qkv_plain(x, mu, inv, wf, c, h * dh), "K3",
             {"bf16": 2 * m * d * wf.shape[1]}, nbytes(x, mu, inv, wf, c),
             product_timer("K3's product: torch.mm(x, W')",
                           lambda: torch.mm(x, wf))),
        patch_embed_case(pe),
    ]


def training_kernel_cases(device, arch=ARCH, batch=BATCH, seed=2):
    """The training path's kernel rows at its shapes: K1 with lse, the two
    attention backward kernels (each against its outputs of the plain
    backward twin) and K8's six kernels, one row each (each row's kernel and
    twin take the kernel chain's inputs; the dh, dy and weight GEMM rows
    carry torch.mm on their products as yardsticks).  Checks first that K8
    as a whole gives the same bits twice."""
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

    flash_bwd = "vit_exp_tpu_torch/csrc/flash_bwd.cu"
    k5 = "vit_exp_tpu/ops/flash_attention.py:868"
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
    ] + k8_cases(device, d, inner, m, g)


def k8_cases(device, d, inner, m, g, tag=""):
    """K8's six kernels at width d, 2I = 2·inner and m tokens, one row each
    (each row's kernel and twin take the kernel chain's inputs; the dh, dy
    and weight GEMM rows carry torch.mm on their products as yardsticks;
    ``tag`` ends each row's name).  Checks first that K8 as a whole gives
    the same bits twice."""
    from vit_exp_tpu_torch.ops import geglu_ff

    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=device) * std

    x = randn(m, d).to(bf)
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    gamma, beta = 1 + 0.1 * randn(d), 0.1 * randn(d)
    w1 = randn(d, 2 * inner, std=d ** -0.5).to(bf)
    w2 = randn(inner, d, std=inner ** -0.5).to(bf)
    dout_ff = randn(m, d, std=1e-3).to(bf)
    ff = (x, mu, inv, gamma, beta, w1, w2, dout_ff)
    same_bits_twice(lambda: geglu_ff.geglu_ff_bwd(*ff),
                    f"K8, both phases, over {m} tokens at D {d}, 2I "
                    f"{2 * inner}: dx, dW1, dW2, dgamma, dbeta")
    # each stage's row takes the kernel chain's inputs
    y = geglu_ff.geglu_bwd_y(x, mu, inv, gamma, beta)
    dh_, act = geglu_ff.geglu_bwd_dh(y, dout_ff, w1, w2)
    dy = geglu_ff.geglu_bwd_dy(dh_, w1)
    _, dgp, dbp = geglu_ff.geglu_bwd_dx(x, mu, inv, gamma, dy)
    gemms = [(a, b, *geglu_ff.wgrad_plan(m, a.shape[1], b.shape[1]))
             for a, b in ((y, dh_), (act, dout_ff))]
    sums = [geglu_ff.wgrad_partials(*gm) for gm in gemms] + [dgp, dbp]
    ff_bwd = "vit_exp_tpu_torch/csrc/geglu_ff_bwd.cu"
    k8 = "vit_exp_tpu/ops/geglu_ff.py:134"
    cases = [
        Case("K8 GEGLU backward, token phase: y = bf16(x̂·γ + β)", "cuda",
             ff_bwd, k8, lambda: geglu_ff.geglu_bwd_y(x, mu, inv, gamma, beta),
             lambda: geglu_ff.geglu_bwd_y_plain(x, mu, inv, gamma, beta),
             "K8y", {}, nbytes(x, mu, inv, gamma, beta)),
        Case("K8 GEGLU backward, token phase: dh and act (dO·W2ᵀ, y·W1, "
             "the GEGLU derivative)", "cuda", ff_bwd, k8,
             lambda: geglu_ff.geglu_bwd_dh(y, dout_ff, w1, w2),
             lambda: geglu_ff.geglu_bwd_dh_plain(y, dout_ff, w1, w2), "K8dh",
             {"bf16": 2 * m * d * 3 * inner}, nbytes(y, dout_ff, w1, w2),
             product_timer("K8's dh stage: torch.mm(dO, W2ᵀ) + torch.mm(y, "
                           "W1), products only, two calls",
                           lambda: (torch.mm(dout_ff, w2.t()),
                                    torch.mm(y, w1)))),
        Case("K8 GEGLU backward, token phase: dy = dh·W1ᵀ (fp32)", "cuda",
             ff_bwd, k8, lambda: geglu_ff.geglu_bwd_dy(dh_, w1),
             lambda: geglu_ff.geglu_bwd_dy_plain(dh_, w1), "K8dy",
             {"bf16": 2 * m * 2 * inner * d}, nbytes(dh_, w1),
             product_timer("K8's dy stage: torch.mm(dh, W1ᵀ), bf16 out",
                           lambda: torch.mm(dh_, w1.t()))),
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
    for case in cases:
        case.name += tag
    return cases


def planted_kernel_cases(device, seed=8):
    """K8's six kernels at the planted path's shape (PLANTED_ARCH at batch
    PLANTED_BATCH: 55,296 tokens, D 384, 2I 2,048)."""
    d = PLANTED_ARCH["dim"]
    m = PLANTED_BATCH * (PLANTED_ARCH["temporal_size"]
                         // PLANTED_ARCH["temporal_patch_size"]
                         * (PLANTED_ARCH["image_size"]
                            // PLANTED_ARCH["patch_size"]) ** 2)
    g = torch.Generator(device=device).manual_seed(seed)
    return k8_cases(device, d, int(4.0 * 2 / 3 * d), m, g,
                    tag=f" (D {d}, the planted path)")


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

    # K12/K13: [γ⊙Wq | Wkv] quantized per channel; its stages take the
    # kernel chain's inputs, W transposed as ln_qkv_int8 hands it over
    w8, sc, c = fused_proj.int8_qkv_weights(
        gamma, randn(d, hd, std=d ** -0.5), randn(d, 2 * hd, std=d ** -0.5))
    qkv = (x, mu, inv, w8, sc, c, hd, hd)
    whole_kernel(lambda: fused_proj.ln_qkv_int8(*qkv),
                 f"K12/K13 over {m} tokens (x8, product)", device)
    x8, sx = fused_proj.ln_qkv_int8_x(x, mu)
    qkv_mm = (x8, sx, mu, inv, w8.t().contiguous(), sc, c, hd, hd)
    print(f"K12/K13's product at F {3 * hd}, fq {hd}, fk {hd}: column tiles "
          f"stored by {fused_proj.k13_store_routes(3 * hd, hd, hd)}",
          flush=True)

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
    xo8 = geglu_ff.quant_rows(xo)[0]
    same_bits_twice(lambda: (fused_proj.proj_int8(xo, wo8, so),),
                    f"K14 over {m} rows")

    proj = "vit_exp_tpu_torch/csrc/ln_qkv_int8.cu"
    k13 = "vit_exp_tpu/ops/fused_proj.py:260"
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
        Case("K12/K13 W8A8 LN + q/k/v projection: x8, s_x (x − μ per "
             "token)", "cuda", proj, k13,
             lambda: fused_proj.ln_qkv_int8_x(x, mu),
             lambda: fused_proj.ln_qkv_int8_x_plain(x, mu), "K13x", {},
             nbytes(x, mu), exact=True),
        Case("K12/K13 W8A8 LN + q/k/v projection: q, k, v = x8·W (the "
             "dequantization in the epilogue)", "cuda", proj, k13,
             lambda: fused_proj.ln_qkv_int8_mm(*qkv_mm),
             lambda: fused_proj.ln_qkv_int8_mm_plain(*qkv_mm), "K13mm",
             {"int8": 2 * m * d * 3 * hd}, nbytes(*qkv_mm[:7]),
             int_mm_timer("K12/K13's product", x8, qkv_mm[4].t()),
             exact=True),
        Case("K14 W8A8 out-projection (one kernel: the rows quantized "
             "into shared memory as wgmma's resident A, Wᵀ by TMA through "
             "an mbarrier ring, int8 wgmma)", "cuda", proj,
             "vit_exp_tpu/ops/fused_proj.py:358",
             lambda: fused_proj.proj_int8(xo, wo8, so),
             lambda: fused_proj.proj_int8_plain(xo, wo8, so), "K14",
             {"int8": 2 * m * hd * d}, nbytes(xo, wo8, so),
             int_mm_timer("K14's product", xo8,
                          wo8.t().contiguous().t()), exact=True),
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
# spill): K1/K15 and the backward pair (each head-dim instance printed
# too), K2's three, K3, K8's six, the int8 attention, K11's four, K12/K13's
# two, the patch embedding and K14
ATTENTION_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                     "flash_bwd_dq_kernel", "flash_static_int8_kernel")
REPORTED_KERNELS = ATTENTION_KERNELS[:3] + (
                    "geglu_ff_x_kernel", "geglu_ff_h_kernel",
                    "geglu_ff_o_kernel", "ln_qkv_kernel",
                    "geglu_bwd_y_kernel", "geglu_bwd_dh_kernel",
                    "geglu_bwd_dy_kernel", "geglu_bwd_dx_kernel",
                    "wgrad_kernel", "sum_rows_kernel",
                    "flash_static_int8_kernel",
                    "geglu_int8_y_kernel", "geglu_int8_h_kernel",
                    "geglu_int8_q_kernel", "geglu_int8_o_kernel",
                    "ln_qkv_int8_x_kernel", "ln_qkv_int8_mm_kernel",
                    "patch_embed_kernel", "proj_int8_kernel")


def ptxas_entries(log: str, names) -> list:
    """(mangled entry name, registers, spill store bytes, spill load bytes)
    of each entry function whose name holds one of ``names``, in the order
    of nvcc's -Xptxas -v output."""
    out, entry, spills = [], None, (0, 0)
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
            if any(name in entry for name in names):
                out.append((entry, int(m.group(1)), *spills))
            entry = None
    return out


def ptxas_report(log: str, names) -> dict:
    """name → (registers, spill store bytes, spill load bytes) for each
    entry function whose (mangled) name holds one of ``names``, read from
    nvcc's -Xptxas -v output; the largest of each over the instances of a
    template."""
    out = {}
    for entry, *new in ptxas_entries(log, names):
        for name in names:
            if name in entry:
                out[name] = tuple(map(max, out.get(name, new), new))
    return out


def kernel_counters():
    from vit_exp_tpu_torch.ops import fused_proj, geglu_ff, patches
    from vit_exp_tpu_torch.ops import flash_attention as fa

    return {"K1": fa.attention_static, "K2x": geglu_ff.geglu_ff_x,
            "K2h": geglu_ff.geglu_ff_h, "K2o": geglu_ff.geglu_ff_o,
            "K3": fused_proj.ln_qkv, "K4": patches.patch_embed,
            "dKdV": fa.attention_bwd_dkv, "dQ": fa.attention_bwd_dq,
            "K8y": geglu_ff.geglu_bwd_y, "K8dh": geglu_ff.geglu_bwd_dh,
            "K8dy": geglu_ff.geglu_bwd_dy, "K8dx": geglu_ff.geglu_bwd_dx,
            "K8w": geglu_ff.wgrad_partials, "K8sum": geglu_ff.sum_rows,
            "K9/K10": fa.attention_static_int8,
            "K11y": geglu_ff.geglu_ff_int8_y, "K11h": geglu_ff.geglu_ff_int8_h,
            "K11q": geglu_ff.geglu_ff_int8_q, "K11o": geglu_ff.geglu_ff_int8_o,
            "K13x": fused_proj.ln_qkv_int8_x,
            "K13mm": fused_proj.ln_qkv_int8_mm, "K14": fused_proj.proj_int8,
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
        check(ok_finite and rel <= REL_L2_TOL and abs_ok
              and (mx == 0 or not case.exact), (case.name, errs))
        rows.append(dict(name=case.name, route=case.route, source=case.source,
                         replaces=case.replaces, counter=case.counter,
                         max_abs_err=mx, rel_l2=rel, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms,
                         **{k: t() for k, t in case.extra.items()}))
        torch.cuda.empty_cache()
    return rows


def build_trainer(device, arch, bert_config, *, use_kernels=True,
                  attn_impl="pallas_static", state_dict=None, seed=0,
                  dcl=False):
    """(model, optimizer, image-report step) in the training configuration:
    unfused LN+qkv, bf16 compute, the trainer settings of bench.py --train;
    attn_impl "pallas_static" (K1, bench.py --train's) or "pallas" (K15,
    run_train's default); ``dcl`` the decoupled contrastive loss."""
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
        decoupled_contrastive_learning=dcl))
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


def patch_embed_grads(model, video, seed=4):
    """The patch embedding's parameter gradients (LayerNorm γ, β, Linear W,
    b) for a seeded N(0, 1) cotangent on its tokens, through the fused
    kernel's Function and through its plain twin: name → (relative L2,
    cosine) of the kernel's against the twin's."""
    from vit_exp_tpu_torch.ops.patches import fused_patch_embed

    vt = model.visual_transformer
    ln_in, proj = vt.to_patch_emb["1"], vt.to_patch_emb["2"]
    params = {"to_patch_emb.1.weight": ln_in.weight,
              "to_patch_emb.1.bias": ln_in.bias,
              "to_patch_emb.2.weight": proj.weight,
              "to_patch_emb.2.bias": proj.bias}
    cot, grads = None, []
    for use_kernel in (True, False):
        out = fused_patch_embed(
            video, ln_in.weight, ln_in.bias, proj.weight.t(), proj.bias,
            vt.temporal_patch_size, vt.patch_size, vt.patch_size,
            compute_dtype=vt.policy.compute_dtype, use_kernel=use_kernel)
        if cot is None:
            g = torch.Generator(device=out.device).manual_seed(seed)
            cot = torch.randn(out.shape, generator=g,
                              device=out.device).to(out.dtype)
        grads.append(torch.autograd.grad(out, list(params.values()), cot))
    return {n: grad_errors(a.float(), b.float())
            for n, a, b in zip(params, *grads)}


def grad_errors(a: torch.Tensor, b: torch.Tensor):
    """(relative L2 error, cosine) of gradient a against reference b; the
    norms are clamped at 1e-30, not at cosine_similarity's 1e-8."""
    a, b = a.flatten().double(), b.flatten().double()
    na, nb = torch.linalg.vector_norm(a), torch.linalg.vector_norm(b)
    return (float(torch.linalg.vector_norm(a - b) / nb.clamp_min(1e-30)),
            float(a @ b / (na * nb).clamp_min(1e-30)))


def compare_train_steps(device, arch, bert_config, batch_size, text_len,
                        attn_impl="pallas_static", dcl=False):
    """From one seeded state on one batch: the image tower's gradients for
    a seeded cotangent through the backward kernels and through their plain
    twins, then one step on the plain versions and one on the kernels (whose
    launches are counted).  Returns the numbers the checks read, the launch
    counts, the kernel trainer (stepped once) and the batch."""
    kern = build_trainer(device, arch, bert_config, attn_impl=attn_impl,
                         dcl=dcl)
    plain = build_trainer(device, arch, bert_config, use_kernels=False,
                          attn_impl=attn_impl, dcl=dcl,
                          state_dict=kern[0].state_dict())
    batch = train_batch(device, arch, bert_config.vocab_size, batch_size,
                        text_len)
    gk, gp = tower_grads(kern[0], batch["image"])
    tower = {n: grad_errors(gk[n], gp[n]) for n in gp}
    del gk, gp
    # the patch embedding's backward reads its forward's statistics:
    # through the kernel against through the plain twin
    tower.update({f"{n} (patch embedding, kernel vs plain forward)": e
                  for n, e in patch_embed_grads(kern[0],
                                                batch["image"]).items()})
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


def run_train_config(folder: Path, name: str, overrides=None,
                     source: Path = RUN_TRAIN_CONFIG) -> str:
    """``source`` (RUN_TRAIN_CONFIG) with its hook list dropped and its
    results folder moved to ``folder``/``name``; ``overrides`` replaces
    top-level keys (the CPU rehearsal's tiny arch).  Returns the written
    YAML's path."""
    import yaml

    cfg = yaml.safe_load(Path(source).read_text())
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
    numbers, with the first run's config and the weights of its ckpt_2 and
    ckpt_3 kept under ``folder``/ckpts, and the throughput run's
    trainer)."""
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
    ckpt_dir = Path(t2.ckpt.directory)
    del t2
    release(device)
    # the two checkpoints' weights stay for the real-format phases
    ckpts = []
    for step in (2, 3):
        keep = folder / "ckpts" / f"ckpt_{step}"
        keep.mkdir(parents=True)
        os.replace(ckpt_dir / f"ckpt_{step}" / "model.pt", keep / "model.pt")
        ckpts.append(str(keep))
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
                launches=launches, ckpts=ckpts,
                config=str(folder / "run.yaml")), tt


# the planted learning path: scripts/train_convergence_torch.py's mid arch
# (dim 384, 4 blocks, patch 10 over 120³ voxels: 1,728 tokens), its text
# tower and batch, at its lr, wd and clip, with the classification hook
PLANTED_ARCH = dict(arch_name="ctvit_3d", dim=384, image_size=120,
                    patch_size=10, temporal_size=120, temporal_patch_size=10,
                    transformer_blocks=4, dim_head=32, heads=8)
PLANTED_TEXT = dict(num_hidden_layers=4, hidden_size=384,
                    num_attention_heads=6, intermediate_size=1536)
PLANTED_BATCH, PLANTED_STEPS, PLANTED_EVAL_EVERY = 32, 20, 10
PLANTED_COUNT_STEP = 15   # a step whose launches are counted
PLANTED_HOOK = "zero_shot_cls_planted"
PLANTED_SCORE_N = 16      # volumes the recipe's scoring engine is held on


def planted_config(folder: Path) -> str:
    """A planted run_train config in ``folder``: PLANTED_STEPS steps of
    single-epoch planted data (one batch more, which the loader has made
    before the profiled step after the run), the hook every
    PLANTED_EVAL_EVERY steps, one loader worker per core.  Returns the
    written YAML's path."""
    cfg = {"random_seed": 0, "results_folder": str(folder / "planted"),
           "trainer": {"lr": 1e-4, "wd": 0.01, "max_grad_norm": 1.0,
                       "num_train_steps": PLANTED_STEPS,
                       "save_model_every": 0,
                       "eval_model_every": PLANTED_EVAL_EVERY,
                       "balance_loss_weight": [1.0]},
           "arch": PLANTED_ARCH, "text_encoder": PLANTED_TEXT,
           "train_data_list": [{"name": "planted", "type": "imagereport",
                                "planted": True,
                                "n": (PLANTED_STEPS + 1) * PLANTED_BATCH,
                                "batch_size": PLANTED_BATCH,
                                "num_workers": os.cpu_count() or 1}],
           "valid_test_list": [PLANTED_HOOK]}
    path = folder / "planted.yaml"
    path.write_text(json.dumps(cfg))   # JSON is YAML
    return str(path)


@contextlib.contextmanager
def watch_hooks():
    """While open, each zero-shot hook that build_eval_hooks makes runs with
    every launch count set to 0 just before it and read just after; yields
    the list of (host seconds, counts, result) of its calls."""
    from vit_exp_tpu_torch.eval import hooks

    runs, make = [], hooks.make_zero_shot_cls_hook

    def counted(*args, **kwargs):
        hook = make(*args, **kwargs)

        def run(model):
            t0 = time.perf_counter()
            res, counts = count_launches(lambda: hook(model))
            runs.append((time.perf_counter() - t0, counts, res))
            return res
        return run

    hooks.make_zero_shot_cls_hook = counted
    try:
        yield runs
    finally:
        hooks.make_zero_shot_cls_hook = make


def planted_phase(device, folder: Path, skip=3):
    """``run_train.main`` on planted data with the classification hook
    (planted_config): checks the eval lines of metrics.jsonl; counts the
    launches of step PLANTED_COUNT_STEP and of each hook call; then the
    recipe's scoring engine (attn_impl="pallas_static", fuse_qkv=True: K1
    and K3) on the trained weights over PLANTED_SCORE_N held-out volumes,
    held against the all-plain engine, its launches counted in one
    predict_batch of 4 volumes.  Returns the numbers (``planted_launches``
    checks the counts)."""
    from vit_exp_tpu_torch.cli import run_train
    from vit_exp_tpu_torch.data.planted import (PLANTED_ATTRS,
                                                PlantedInferenceDataset)
    from vit_exp_tpu_torch.data.tokenizer import load_tokenizer
    from vit_exp_tpu_torch.eval.zero_shot import ZeroShotClassifier
    from vit_exp_tpu_torch.models.factory import bert_config_for, build_ctclip

    with watch_steps(PLANTED_COUNT_STEP) as (marks, launches), \
            watch_hooks() as hook_runs:
        tr = run_train.main(["--config", planted_config(folder), "--debug"],
                            device=device)
    check(tr.status == "completed" and tr.step == PLANTED_STEPS,
          (tr.status, tr.step))
    lines = read_metrics(folder / "planted")
    prefix = f"eval/{PLANTED_HOOK}/"
    eval_keys = ({f"{prefix}{a}_auc" for a in PLANTED_ATTRS}
                 | {f"{prefix}mean_auc", f"{prefix}volumes_per_sec"})
    order = [(d["step"], any(k.startswith(prefix) for k in d)) for d in lines]
    want = [(i, False) for i in range(1, PLANTED_STEPS + 1)]
    for i in range(PLANTED_EVAL_EVERY, PLANTED_STEPS + 1, PLANTED_EVAL_EVERY):
        want.insert(want.index((i, False)) + 1, (i, True))
    evals = [d for d in lines if any(k.startswith(prefix) for k in d)]
    check(order == want, ("metrics.jsonl order", order))
    check(all(set(d) - {"_time", "step"} == eval_keys
              and all(math.isfinite(d[k]) for k in eval_keys) for d in evals),
          evals)
    for sec, counts, res in hook_runs:
        print(f"hook {PLANTED_HOOK}: {sec:.3f} s, result {res}", flush=True)
    check(len(hook_runs) == PLANTED_STEPS // PLANTED_EVAL_EVERY, hook_runs)
    window = marks[skip:]
    (_, t_a, w_a, b_a), (_, t_b, w_b, b_b) = window[0], window[-1]
    out = dict(launches=launches, hook_launches=[r[1] for r in hook_runs],
               evals=evals, hook_s=[r[0] for r in hook_runs],
               window=(skip + 1, PLANTED_STEPS - 1),
               sps=(len(window) - 1) / (t_b - t_a),
               wait_s=(w_b - w_a) / (b_b - b_a),
               losses=[d["ds0_cl_loss"] for d in lines
                       if "ds0_cl_loss" in d])
    check(all(math.isfinite(x) for x in out["losses"]), out["losses"])

    if device.type == "cuda":   # the CPU rehearsal has no device trace
        out["wall_ms"], out["busy_ms"] = profile_call(
            lambda: [float(v) for v in tr.train_step().values()],
            OUT_DIR / "profile_planted.txt", "one planted run_train step")

    # the recipe's scoring engine on the trained weights, against plain
    state, config = tr.model.state_dict(), tr.config
    tokenizer = load_tokenizer()
    bert = bert_config_for(config, tokenizer)
    del tr
    release(device)
    engines = []
    for use_kernels in (True, False):
        model = build_ctclip(config, bert, device=device,
                             use_kernels=use_kernels,
                             attn_impl="pallas_static", fuse_qkv=True)
        model.load_state_dict(state)
        engines.append(ZeroShotClassifier(
            model, tokenizer, pathologies=list(PLANTED_ATTRS),
            max_text_len=64, batch_size=4))
    ds = PlantedInferenceDataset(PLANTED_SCORE_N, arch=config.arch, seed=1)
    vols = np.stack([ds[i]["image"] for i in range(PLANTED_SCORE_N)])
    engines[0].prepare()
    _, out["score_launches"] = count_launches(
        lambda: engines[0].predict_batch(vols[:4]))
    probs = [np.concatenate([e.predict_batch(vols[i:i + 4])
                             for i in range(0, PLANTED_SCORE_N, 4)])
             for e in engines]
    dprob = float(np.abs(probs[0] - probs[1]).max())
    res = engines[0].infer(ds, num_workers=os.cpu_count() or 1)
    print(f"recipe's scoring engine (K1, K3 at D {PLANTED_ARCH['dim']}) on "
          f"{PLANTED_SCORE_N} planted volumes after {PLANTED_STEPS} steps: "
          f"max |prob(kernels) - prob(plain)| = {dprob:.3e} (tolerance "
          f"{PROB_TOL}); infer {res} (printed, not bounded)", flush=True)
    check(probs[0].shape == (PLANTED_SCORE_N, len(PLANTED_ATTRS))
          and bool(np.isfinite(probs[0]).all()) and dprob <= PROB_TOL, dprob)
    out.update(score_dprob=dprob, score=res)
    del engines
    release(device)
    return out


def train_launches(blocks: int) -> dict:
    """The launches of one train step at attn_impl="pallas" (K15): per block
    K15 with lse, the backward pair, K2's three kernels, K8's y, dh, dy and
    dx, its weight GEMM twice (dW1, dW2) and its ordered sum four times
    (dW1, dW2, dgamma, dbeta); the patch embedding once."""
    return expected_launches({
        "K15": blocks, "dKdV": blocks, "dQ": blocks, "K2x": blocks,
        "K2h": blocks, "K2o": blocks, "K4": 1, "K8y": blocks,
        "K8dh": blocks, "K8dy": blocks, "K8dx": blocks, "K8w": 2 * blocks,
        "K8sum": 4 * blocks})


def planted_launches(pl: dict) -> None:
    """Check planted_phase's counts: the train step runs K15 with lse, the
    backward pair, K2, K8 at D 384 and the patch embedding once a block (K8's
    weight GEMM twice and its sums four times); each hook call, 10 volumes
    at batch 2 (JAX's limit and batch size), runs the forward kernels on the
    trainer's model (K15, K2, the patch embedding), nothing plain; the
    recipe's scoring engine runs K1, K3, K2 and the patch embedding."""
    blocks = PLANTED_ARCH["transformer_blocks"]
    ff = {"K2x": blocks, "K2h": blocks, "K2o": blocks}
    expected = {
        "step": train_launches(blocks),
        "hook": expected_launches({"K15": 5 * blocks, "K4": 5,
                                   **{k: 5 * blocks for k in ff}}),
        "score": expected_launches({"K1": blocks, "K3": blocks, **ff,
                                    "K4": 1})}
    for what, got in (("step", [pl["launches"]]),
                      ("hook", pl["hook_launches"]),
                      ("score", [pl["score_launches"]])):
        print(f"planted path, launches of each {what}: {got} (expected "
              f"{expected[what]})", flush=True)
        check(got and all(c == expected[what] for c in got), (what, got))


# --- the segmentation paths ---------------------------------------------------

# full width (ARCH): the closed-set seg config (seg head of mid 1024 and out
# 22, so 22 × 4,000 = 88,000 features a token), the open-seg config
# (clip_focal_loss γ 2 α 0.25, down factor 4, heads of mid 128 and out 16)
# and its fusion arm (fix_text_encoder, choose_cls [5], a fusion MLP
# 32 → 16 → 1)
SEG_CONFIG = ROOT / "configs" / "ct_clip_vit_seg.yaml"
OPEN_SEG_CONFIG = ROOT / "configs" / "ct_clip_vit_open_seg.yaml"
FUSION_CONFIG = (ROOT / "configs"
                 / "ct_clip_vit_open_seg_fusion_single_cls.yaml")
SEG_BATCH = 1
# class prompts BERT-base encodes: 4 on the open-seg step, 6 on the fusion
# arm, whose choose_cls [5] names the sixth class
OPEN_SEG_PROMPTS, FUSION_PROMPTS, PROMPT_LEN = 4, 6, 32
SEG_SERVE_VOLUMES = 2
# the seg logits are a per-voxel readout of bf16 tokens, and at random
# weights they carry the path's own rounding noise: a relative
# SEG_NOISE_EPS perturbation of the volume (below the kernels' own
# disagreement with their twins) moves the plain int8 path's logits by
# 1.6% and the bf16 path's by 0.7% (the card tests' small arch, on the
# CPU), since every changed int8 code moves its value by a whole
# quantization step.  So the int8 logits are held to their plain path
# within SEG_NOISE_FACTOR × that path's own response to such a
# perturbation, measured in the same run (never tighter than REL_L2_TOL);
# the bf16 logits within REL_L2_TOL.
SEG_NOISE_EPS, SEG_NOISE_FACTOR = 1e-4, 1.5
# configs/planted_mixed.yaml as is (mid arch, three loaders, the Combined
# sampler, both hooks), MIXED_STEPS steps with the hooks every
# MIXED_EVAL_EVERY; the micro-steps of step MIXED_COUNT_STEP are counted
MIXED_CONFIG = ROOT / "configs" / "planted_mixed.yaml"
MIXED_STEPS, MIXED_EVAL_EVERY, MIXED_COUNT_STEP = 12, 6, 9
MIXED_TYPES = ("imagereport", "imageseg", "imageopenseg")
SEG_HOOK = "seg_test_planted"


def load_seg_config(path: Path):
    from vit_exp_tpu_torch.core.config import load_config

    return load_config(str(path))


def arch_dict(config) -> dict:
    return {k: getattr(config.arch, k) for k in ARCH}


def seg_batch(device, config, n_classes: int, n_prompts: int = 0,
              vocab_size: int = 0, seed: int = 11) -> dict:
    """A seeded batch made on the device, not through the host (at 22
    classes the synthetic fp32 mask is 4.87 GB a volume): SEG_BATCH volumes
    uniform in [0, 1) in bf16, a uint8 mask of n_classes channels (rand >
    0.8, made a class at a time) and n_prompts prompts of PROMPT_LEN random
    ids."""
    a = config.arch
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (SEG_BATCH, 1, a.temporal_size, a.image_size, a.image_size)
    batch = {"image": torch.rand(shape, generator=g,
                                 device=device).to(torch.bfloat16),
             "seg_mask": torch.cat([
                 (torch.rand(shape, generator=g, device=device) > 0.8)
                 .to(torch.uint8) for _ in range(n_classes)], dim=1)}
    if n_prompts:
        ids = torch.randint(1, vocab_size, (n_prompts, PROMPT_LEN),
                            generator=g, device=device)
        batch.update(prompt_ids=ids, prompt_mask=torch.ones_like(ids))
    return batch


def build_seg_trainer(device, config, bert_config, data_type, *,
                      use_kernels=True, state_dict=None):
    """(model, optimizer, step of data_type) at run_train's default
    attention (attn_impl="pallas", K15), the trainer settings of bench.py
    --train."""
    from vit_exp_tpu_torch.models.factory import build_ctclip
    from vit_exp_tpu_torch.train.optimizer import build_optimizer
    from vit_exp_tpu_torch.train.steps import make_train_steps

    model = build_ctclip(config, bert_config, device=device,
                         use_kernels=use_kernels, attn_impl="pallas", seed=0)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model.train()
    opt = build_optimizer(types.SimpleNamespace(**TRAINER), model.parameters())
    return model, opt, make_train_steps(model, opt, config)[data_type]


def seg_outputs(model, batch, data_type) -> list:
    """One forward of the step's model path: the seg logits, or the voxel
    and prompt embeddings."""
    with torch.no_grad():
        if data_type == "imageseg":
            return [model.seg_forward(batch["image"])]
        out = model.open_seg_forward(batch["image"], batch["prompt_ids"],
                                     batch["prompt_mask"])
        return [out["seg_preds"], out["prompt_logits"]]


def seg_parts_ms(model, config, batch, data_type) -> dict:
    """Device ms of the step's head (its products, LeakyReLU and the
    unpatchify; forward and backward for a seeded cotangent) and of its
    loss (forward and backward), on one forward's tokens: the parts the
    kernels do not run."""
    from vit_exp_tpu_torch.models.losses import open_seg_loss, seg_bce_loss

    ca = config.ct_clip_arch
    with torch.no_grad():
        tokens = model.encode_image_tokens(batch["image"])
    head_module = (model.seg_head if data_type == "imageseg"
                   else model.open_seg_head)
    g = torch.Generator(device=tokens.device).manual_seed(5)
    with torch.no_grad():
        out = model.head_voxels(head_module, tokens)
    cot = torch.randn(out.shape, generator=g, device=out.device).to(out.dtype)

    def head():
        torch.autograd.backward(model.head_voxels(head_module, tokens), cot)

    if data_type == "imageseg":
        logits = out.detach().requires_grad_()

        def loss():
            seg_bce_loss(logits, batch["seg_mask"]).backward()
    else:
        emb = seg_outputs(model, batch, data_type)
        preds, prompts = (t.detach().requires_grad_() for t in emb)
        f = ca.open_seg_loss_down_factor
        mask = batch["seg_mask"][:, :, ::f, ::f, ::f]
        flat = mask.permute(0, 2, 3, 4, 1).reshape(mask.shape[0], -1,
                                                   mask.shape[1])

        def loss():
            open_seg_loss(
                preds, flat, prompts, loss_type=ca.open_seg_loss_type,
                hyper=ca.open_seg_loss_hyper_config,
                fusion_head_apply=(model.apply_fusion_head
                                   if ca.fusion_head is not None
                                   else None)).backward()
    del out
    res = {"head_ms": cuda_ms(head, 3), "loss_ms": cuda_ms(loss, 3)}
    model.zero_grad(set_to_none=True)
    return res


def seg_train_phase(device, config, bert_config, data_type, expected: dict,
                    tag: str, n_classes: int, n_prompts: int = 0,
                    timed: int = 3):
    """The seg or open-seg train step at full width (batch SEG_BATCH), from
    one seeded state on one batch: the forward's outputs of the kernel path
    against the plain path (relative L2), then one step on plain and one
    on the kernels (its launches counted, its peak device memory read):
    losses within LOSS_RTOL, global gradient norms within GRAD_NORM_RTOL,
    every parameter plain gives a gradient gets one from the kernels.
    Then ``timed`` warm steps, one profiled step and the head's and the
    loss's device time.  Returns the numbers."""
    kern = build_seg_trainer(device, config, bert_config, data_type)
    plain = build_seg_trainer(device, config, bert_config, data_type,
                              use_kernels=False,
                              state_dict=kern[0].state_dict())
    batch = seg_batch(device, config, n_classes, n_prompts,
                      bert_config.vocab_size)
    outs = [seg_outputs(m, batch, data_type) for m in (kern[0], plain[0])]
    fwd_rel = max(compare(a, b)[0] for a, b in zip(*outs))
    finite = all(bool(torch.isfinite(t.float()).all()) for t in outs[0])
    del outs
    lp, np_, sp = step_grads(plain, batch)
    del plain
    release(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    (lk, nk, sk), launches = count_launches(lambda: step_grads(kern, batch))
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if device.type == "cuda" else float("nan"))
    dloss = abs(lk - lp) / abs(lp)
    dnorm = abs(nk - np_) / np_
    missing = sorted(sp - sk)
    print(f"{tag} step at full width, batch {SEG_BATCH}: forward outputs "
          f"kernels vs plain rel L2 {fwd_rel:.3e} (tolerance {REL_L2_TOL}); "
          f"loss kernels {lk:.6f}, plain {lp:.6f} (rel {dloss:.3e}, "
          f"tolerance {LOSS_RTOL}); grad norm kernels {nk:.6f}, plain "
          f"{np_:.6f} (rel {dnorm:.3e}, tolerance {GRAD_NORM_RTOL}); "
          f"parameters without a kernel-path gradient: {missing}; peak "
          f"device memory of the kernel step {peak_gb:.3f} GB", flush=True)
    print(f"launches in one {tag} step: {launches} (expected {expected})",
          flush=True)
    check(finite and fwd_rel <= REL_L2_TOL, (tag, "forward", fwd_rel))
    check(math.isfinite(lk) and math.isfinite(lp) and dloss <= LOSS_RTOL,
          (tag, lk, lp))
    check(dnorm <= GRAD_NORM_RTOL, (tag, dnorm))
    check(sp and not missing, (tag, missing))
    check(launches == expected, (tag, launches))

    model, _, step = kern
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        float(step(batch, 1.0)["loss"])
        times.append(time.perf_counter() - t0)
    out = dict(launches=launches, loss=lk, fwd_rel=fwd_rel, dloss=dloss,
               dnorm=dnorm, peak_gb=peak_gb, times=times)
    if device.type == "cuda":
        out["wall_ms"], out["busy_ms"] = profile_call(
            lambda: float(step(batch, 1.0)["loss"]),
            OUT_DIR / f"profile_{tag.replace('-', '_').replace(' ', '_')}"
                      f".txt", f"one {tag} step")
        out.update(seg_parts_ms(model, config, batch, data_type))
        print(f"{tag} step: head (products, LeakyReLU, unpatchify; forward "
              f"and backward) {out['head_ms']:.3f} ms, loss (forward and "
              f"backward) {out['loss_ms']:.3f} ms, of a "
              f"{statistics.median(times) * 1e3:.3f} ms warm step", flush=True)
    del kern, model, step, batch
    release(device)
    return out


def seg_serve_phase(device, config_path: Path, folder: Path, int8: bool,
                    expected: dict, timed: int = 3):
    """``run_zero_shot_seg.main`` on --synthetic SEG_SERVE_VOLUMES with the
    config's arch at random weights (seed 0), at its int8 default or with
    --no-int8: its launches counted over the call, finite per-class dice;
    then volume 0's logits of the kernel path (the weights main built)
    against the all-plain path, within REL_L2_TOL, and warm dice calls of
    one volume on the card, timed.  Returns the numbers and volume 0's
    logits."""
    from vit_exp_tpu_torch.cli import run_zero_shot_seg
    from vit_exp_tpu_torch.data.synthetic import SyntheticCTDataset
    from vit_exp_tpu_torch.data.tokenizer import load_tokenizer
    from vit_exp_tpu_torch.eval.zero_shot import ZeroShotSegmenter
    from vit_exp_tpu_torch.models.factory import bert_config_for, build_ctclip

    tag = "int8" if int8 else "bf16"
    argv = ["--config", str(config_path), "--synthetic",
            str(SEG_SERVE_VOLUMES), "--results_folder", str(folder / tag)]
    t0 = time.perf_counter()
    res, launches = count_launches(lambda: run_zero_shot_seg.main(
        argv + ([] if int8 else ["--no-int8"]), device=device))
    call_s = time.perf_counter() - t0
    print(f"run_zero_shot_seg ({tag}), {SEG_SERVE_VOLUMES} synthetic "
          f"volumes: {res} in {call_s:.3f} s; launches {launches} "
          f"(expected {expected})", flush=True)
    check(res and all(math.isfinite(v) for v in res.values()), (tag, res))
    check(launches == expected, (tag, launches))

    config = load_seg_config(config_path)
    bert = bert_config_for(config, load_tokenizer())
    mode = (dict(int8=True) if int8 else dict(attn_impl="pallas_static"))
    kern = build_ctclip(config, bert, device=device, fuse_qkv=True, **mode)
    plain = build_ctclip(config, bert, device=device, fuse_qkv=True,
                         use_kernels=False, **mode)
    plain.load_state_dict(kern.state_dict())
    # volume 0 of the served set: its volume is drawn before its mask, so
    # a one-class set gives the same bytes
    vol = torch.as_tensor(SyntheticCTDataset(
        "imageseg", n=1, arch=config.arch, n_classes=1)[0]["image"][None],
        device=device)
    g = torch.Generator(device=device).manual_seed(7)
    noise = torch.randn(vol.shape, generator=g, device=device)
    with torch.inference_mode():
        logits = kern.seg_forward(vol)
        ref = plain.seg_forward(vol)
        rel = compare(logits, ref)[0]
        floor = compare(plain.seg_forward(vol * (1 + SEG_NOISE_EPS * noise)),
                        ref)[0]
    tol = max(REL_L2_TOL, SEG_NOISE_FACTOR * floor) if int8 else REL_L2_TOL
    print(f"seg serving ({tag}) volume 0: logits kernels vs plain rel L2 "
          f"{rel:.3e} (tolerance {tol:.3e}); the plain path's own response "
          f"to a {SEG_NOISE_EPS} relative perturbation of the volume "
          f"{floor:.3e}", flush=True)
    check(bool(torch.isfinite(logits.float()).all()) and rel <= tol,
          (tag, rel, tol))
    del ref, noise
    del plain
    release(device)
    mask = (torch.rand(logits.shape, device=device) > 0.8).to(torch.uint8)
    eng = ZeroShotSegmenter(kern)
    times = []
    for _ in range(timed + 1):
        t0 = time.perf_counter()
        eng.dice_batch(vol, mask)
        times.append(time.perf_counter() - t0)
    times = times[1:]
    out = dict(res=res, launches=launches, rel=rel, floor=floor, tol=tol,
               call_s=call_s,
               times=times, vps=1.0 / statistics.median(times))
    if device.type == "cuda":
        out["wall_ms"], out["busy_ms"] = profile_call(
            lambda: eng.dice_batch(vol, mask),
            OUT_DIR / f"profile_seg_serving_{tag}.txt",
            f"one {tag} seg dice call (1 volume)")
    del eng, kern, mask, vol
    release(device)
    return out, logits


def mixed_batches():
    """(the image-report loader's batch, the seg and open-seg loaders'
    batch) of MIXED_CONFIG."""
    import yaml

    specs = yaml.safe_load(MIXED_CONFIG.read_text())["train_data_list"]
    sizes = {s["type"]: int(s["batch_size"]) for s in specs}
    check(sizes["imageseg"] == sizes["imageopenseg"], sizes)
    return sizes["imagereport"], sizes["imageseg"]


def mixed_config(folder: Path, overrides=None) -> str:
    """MIXED_CONFIG as is, its results moved to ``folder``/mixed and its
    hooks every MIXED_EVAL_EVERY steps (``overrides`` replaces top-level
    keys: the CPU rehearsal's tiny arch).  Returns the written path."""
    import yaml

    cfg = yaml.safe_load(MIXED_CONFIG.read_text())
    cfg["results_folder"] = str(folder / "mixed")
    cfg["trainer"]["eval_model_every"] = MIXED_EVAL_EVERY
    cfg.update(overrides or {})
    path = folder / "mixed.yaml"
    path.write_text(json.dumps(cfg))   # JSON is YAML
    return str(path)


@contextlib.contextmanager
def watch_micro_steps(count_step: int):
    """While open, every CTClipTrainer notes (the step it starts, the host
    clock, its loader wait and batches so far) as each step starts, and in
    step ``count_step`` each micro-step
    runs with every launch count set to 0 just before it and read just
    after, summed by data type.  Yields (the notes, {type: counts})."""
    from vit_exp_tpu_torch.train.trainer import CTClipTrainer

    marks, by_type = [], {}
    inner = CTClipTrainer.train_step

    def counted(name, fn):
        def run(batch, weight):
            out, counts = count_launches(lambda: fn(batch, weight))
            acc = by_type.setdefault(name, dict.fromkeys(counts, 0))
            for k, v in counts.items():
                acc[k] += v
            return out
        return run

    def train_step(self):
        marks.append((self.step + 1, time.perf_counter(), self.data_wait_s,
                      self.batches))
        if self.step + 1 != count_step:
            return inner(self)
        saved = self.steps_by_type
        self.steps_by_type = {n: counted(n, f) for n, f in saved.items()}
        try:
            return inner(self)
        finally:
            self.steps_by_type = saved

    CTClipTrainer.train_step = train_step
    try:
        yield marks, by_type
    finally:
        CTClipTrainer.train_step = inner


def mixed_phase(device, folder: Path, overrides=None, steps=MIXED_STEPS,
                count_step=MIXED_COUNT_STEP, skip=3):
    """``run_train.main`` on MIXED_CONFIG (mixed_config) for ``steps``
    steps: checks finite cl_loss, seg_loss and open_seg_loss lines from the
    three loaders at every step, the seg hook's lines with a finite
    mean_dice (and the classification hook's with a finite mean_auc) at
    every MIXED_EVAL_EVERY-th step; counts the launches of each step type
    in step ``count_step``.  Returns the numbers."""
    from vit_exp_tpu_torch.cli import run_train

    with watch_micro_steps(count_step) as (marks, by_type):
        tr = run_train.main(["--config", mixed_config(folder, overrides),
                             "--debug", "--steps", str(steps)], device=device)
    check(tr.status == "completed" and tr.step == steps
          and tr.data_types == list(MIXED_TYPES), (tr.status, tr.data_types))
    lines = read_metrics(folder / "mixed")
    train = [d for d in lines if "ds0_cl_loss" in d]
    keys = ("ds0_cl_loss", "ds1_seg_loss", "ds2_open_seg_loss")
    check([d["step"] for d in train] == list(range(1, steps + 1))
          and all(math.isfinite(d[k]) for d in train for k in keys), train)
    seg = [d for d in lines if f"eval/{SEG_HOOK}/mean_dice" in d]
    cls = [d for d in lines if "eval/zero_shot_cls_planted/mean_auc" in d]
    hook_steps = list(range(MIXED_EVAL_EVERY, steps + 1, MIXED_EVAL_EVERY))
    check([d["step"] for d in seg] == hook_steps
          and all(math.isfinite(d[f"eval/{SEG_HOOK}/mean_dice"])
                  for d in seg), seg)
    check([d["step"] for d in cls] == hook_steps
          and all(math.isfinite(d["eval/zero_shot_cls_planted/mean_auc"])
                  for d in cls), cls)
    check(set(by_type) == set(MIXED_TYPES), by_type)
    window = marks[skip:]
    out = dict(by_type=by_type, losses={k: [d[k] for d in train]
                                        for k in keys},
               seg_dice=[d[f"eval/{SEG_HOOK}/mean_dice"] for d in seg],
               cls_auc=[d["eval/zero_shot_cls_planted/mean_auc"]
                        for d in cls],
               window=(skip + 1, steps - 1),
               sps=(len(window) - 1) / (window[-1][1] - window[0][1]),
               wait_s=tr.data_wait_s / max(tr.batches, 1))
    if device.type == "cuda":
        out["wall_ms"], out["busy_ms"] = profile_call(
            lambda: [float(v) for v in tr.train_step().values()],
            OUT_DIR / "profile_planted_mixed.txt",
            "one planted_mixed run_train step (three micro-steps)")
    del tr
    release(device)
    return out


def seg_train_cases(device, arch=ARCH, batch=SEG_BATCH, tag="", seed=12):
    """The kernel rows of a train step at attn_impl="pallas" at (arch,
    batch): K15 with lse and the backward pair over the concatenated kv,
    K2's three stages, the patch embedding and K8's six kernels."""
    arch = dict(arch, channels=arch.get("channels", 1))
    d = arch["dim"]
    m = batch * (arch["temporal_size"] // arch["temporal_patch_size"]
                 * (arch["image_size"] // arch["patch_size"]) ** 2)
    cases = ([c for c in online_kernel_cases(device, arch, batch, seed)
              if c.counter != "K15" or "lse" in c.name]
             + [c for c in kernel_cases(device, arch, batch, seed + 1)
                if c.counter in ("K2x", "K2h", "K2o", "K4")]
             + k8_cases(device, d, int(4.0 * 2 / 3 * d), m,
                        torch.Generator(device=device).manual_seed(seed + 2)))
    for case in cases:
        case.name += tag
    return cases


def seg_serve_cases(device, int8: bool, arch=ARCH, batch=SEG_BATCH,
                    seed=14, tag=None):
    """The seg serving path's kernel rows at one volume (or ``batch``, with
    ``tag`` ending each row's name): K1, K2, K3 and the patch embedding
    (bf16), or the int8 kernels and the patch embedding."""
    if int8:
        cases = int8_kernel_cases(device, arch, batch, seed) + [
            patch_embed_case(patch_embed_inputs(
                device, torch.Generator(device=device).manual_seed(seed + 1),
                arch, batch))]
    else:
        cases = kernel_cases(device, arch, batch, seed)
    for case in cases:
        case.name += tag or (f" (seg serving, {'int8' if int8 else 'bf16'}, "
                             f"batch {batch})")
    return cases


def path_rows(rows: list, path: str, counts: dict) -> list:
    """Copies of a phase's measured rows for one path: its name in the row
    name, its launch counts; a row whose kernel the path never launched
    fails the run."""
    out = []
    for row in rows:
        n = counts[row["counter"]]
        check(n > 0, (path, row["name"], "never launched"))
        out.append({**{k: v for k, v in row.items() if k != "counter"},
                    "name": f"{row['name']} [{path}]", "launches": n})
    return out


# the real-format data path: the NIfTI reader and the offline preprocessing
# (host and card), a CT-RATE npz tree and its CSVs, the packed store and its
# native reader, run_zero_shot_cls over both and as a checkpoint sweep, and
# the HTTP server under concurrent clients
CT_RAW_HWD = (512, 512, 300)              # a raw CT volume, int16
CT_RAW_SPACING = (1.0, 0.7, 0.7)          # (z, x, y) mm
NIFTI_HWD = ((512, 512, 120), (400, 400, 96))
NIFTI_SPACING = ((2.0, 0.7), (1.25, 0.9))   # (z, xy) of each file
PREP_RTOL = 1e-5    # card against CPU, relative L2 (fp32 lerps, FMAs)
# (D, H, W) of the npz volumes: larger and smaller than the runtime target
# (240, 480, 480) on each axis among them, so the crop and the pad both run
CTRATE_DHW = ((250, 500, 470), (200, 460, 500), (260, 512, 512),
              (180, 420, 430), (240, 480, 480), (230, 490, 470),
              (300, 400, 520), (210, 500, 450))
CLS_BATCH = 4
# served probabilities are held bit for bit to predict_batch's on the batch
# each was dispatched in, and within PROB_TOL (printed) to predict_batch's
# on the volume alone: the int8 attention quantizes k at one scale over the
# whole batch (as JAX's K10 does), so a volume's int8 probabilities move
# with its batch companions
SERVE_CLIENTS, SERVE_ROUNDS = 8, 2


def write_nifti(path: Path, data: np.ndarray, pixdim) -> None:
    """A NIfTI-1 int16 file (gzip level 1 for .nii.gz), the header the
    reader needs: dim, datatype 4, pixdim, vox_offset 352, no scaling."""
    import gzip
    import struct

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, *data.shape, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, 4)
    struct.pack_into("<8f", hdr, 76, 1.0, *pixdim, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<ff", hdr, 112, 1.0, 0.0)
    payload = bytes(hdr) + data.astype("<i2").tobytes(order="F")
    if path.name.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(payload)
    else:
        path.write_bytes(payload)


def filesystem_of(path: Path) -> str:
    """The mount point and type of the file system holding ``path`` (the
    longest mount point of /proc/mounts above it)."""
    real = os.path.realpath(path)
    best, kind = "", "?"
    with open("/proc/mounts") as f:
        for line in f:
            _, mnt, fstype = line.split()[:3]
            inside = real == mnt or real.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(best):
                best, kind = mnt, fstype
    return f"{best} ({kind})"


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def timed(fn, device):
    """(fn(), host seconds with the device synchronised after)."""
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def prep_phase(device, folder: Path, raw_hwd=CT_RAW_HWD,
               nifti_hwd=NIFTI_HWD) -> dict:
    """The offline stage on a raw CT-sized volume, on ``device`` and on the
    CPU (relative L2 ≤ PREP_RTOL, both timed, from the numpy volume to the
    result on the device); then ``preprocess_ctrate.main`` on two written
    NIfTI files (one .nii.gz, one .nii) by the host path and, on a card,
    with --device: the npz trees within PREP_RTOL."""
    from vit_exp_tpu_torch.cli import preprocess_ctrate
    from vit_exp_tpu_torch.ops import preprocess as pp

    r = np.random.default_rng(20)
    img = r.integers(-1024, 2500, raw_hwd, dtype=np.int16)
    shape = pp.spacing_resample_shape((raw_hwd[2], raw_hwd[0], raw_hwd[1]),
                                      CT_RAW_SPACING)
    kw = dict(slope=1.0, intercept=-1024.0, new_shape=shape)
    pp.preprocess_offline_volume(img, device=device, **kw)   # warm
    got, dev_s = timed(lambda: pp.preprocess_offline_volume(
        img, device=device, **kw), device)
    ref, cpu_s = timed(lambda: pp.preprocess_offline_volume(
        img, device="cpu", **kw), torch.device("cpu"))
    rel = rel_l2(got.cpu(), ref)
    check(tuple(got.shape) == shape and rel <= PREP_RTOL, ("offline", rel))
    del got, ref, img
    src = folder / "nifti"
    src.mkdir()
    rows = ["VolumeName,RescaleSlope,RescaleIntercept,XYSpacing,ZSpacing"]
    for i, (hwd, (z, xy)) in enumerate(zip(nifti_hwd, NIFTI_SPACING)):
        name = f"train_{i}_a_1.nii" + (".gz" if i == 0 else "")
        write_nifti(src / name, r.integers(-1024, 2500, hwd, dtype=np.int16),
                    (xy, xy, z))
        rows.append(f'{name},1,-1024,"[{xy}, {xy}]",{z}')
    (folder / "metadata.csv").write_text("\n".join(rows) + "\n")
    trees, cli_s = {}, {}
    for tag, flag in (("host", []), ("card", ["--device"])):
        if flag and device.type != "cuda":
            continue
        t0 = time.perf_counter()
        preprocess_ctrate.main(["--src", str(src), "--metadata",
                                str(folder / "metadata.csv"), "--out",
                                str(folder / tag), "--workers", "2"] + flag)
        cli_s[tag] = time.perf_counter() - t0
        trees[tag] = sorted((folder / tag).rglob("*.npz"))
        check(len(trees[tag]) == len(nifti_hwd), (tag, trees[tag]))
    cli_rel = max((rel_l2(np.load(a)["arr_0"], np.load(b)["arr_0"])
                   for a, b in zip(trees.get("card", []), trees["host"])),
                  default=0.0)
    check(cli_rel <= PREP_RTOL, ("preprocess_ctrate", cli_rel))
    return dict(shape=shape, rel=rel, dev_s=dev_s, cpu_s=cpu_s,
                cli_rel=cli_rel, cli_s=cli_s)


def ctrate_files(folder: Path, dhw=CTRATE_DHW, seed=21):
    """An npz tree in CT-RATE's layout (``valid_{i}/valid_{i}a/
    valid_{i}_a_1.npz``, ``arr_0`` (D, H, W) fp32 in [−1.2, 1.2]), a
    reports CSV with one empty Findings_EN cell and an 18-column labels CSV
    with one empty cell.  Returns (tree, reports, labels, accessions)."""
    from vit_exp_tpu_torch.eval.zero_shot import PATHOLOGIES

    r = np.random.default_rng(seed)
    names = []
    for i, shape in enumerate(dhw):
        sub = folder / "tree" / f"valid_{i}" / f"valid_{i}a"
        sub.mkdir(parents=True)
        vol = r.standard_normal(shape, dtype=np.float32)
        np.clip(vol * np.float32(0.4), -1.2, 1.2, out=vol)
        np.savez(sub / f"valid_{i}_a_1.npz", vol)
        names.append(f"valid_{i}_a_1.nii.gz")
    reports = folder / "reports.csv"
    reports.write_text("VolumeName,Findings_EN,Impressions_EN\n" + "".join(
        f"{n},{'' if i == 1 else f'finding {i}'},impression {i}\n"
        for i, n in enumerate(names)))
    y = (r.random((len(names), 18)) > 0.5).astype(int).astype(str)
    y[0], y[1] = "1", "0"
    y[2, 5] = ""
    labels = folder / "labels.csv"
    labels.write_text("VolumeName," + ",".join(PATHOLOGIES) + "\n" + "".join(
        n + "," + ",".join(row) + "\n" for n, row in zip(names, y)))
    return folder / "tree", str(reports), str(labels), names


def native_phase(store) -> dict:
    """The native reader: built and loaded; get_batch of CLS_BATCH records
    byte-equal to the memmap slices cast to fp32; its read rate (the
    records' stored bytes over the median of 3 reads) beside the same
    records' through memmap slices cast by numpy on one thread."""
    from vit_exp_tpu_torch import native

    check(native.available(), ("native reader", native.build_error()))
    keys = store.keys()[:CLS_BATCH]
    got = store.get_batch(keys)
    want = np.stack([store.get(k) for k in keys]).astype(np.float32)
    check(got.dtype == np.float32 and np.array_equal(got, want),
          "get_batch against the memmap slices")
    del want
    times, numpy_times = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        store.get_batch(keys, out=got)
        times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()   # the same bytes through memmap and numpy
        for i, k in enumerate(keys):
            np.copyto(got[i], store.get(k), casting="same_kind")
        numpy_times.append(time.perf_counter() - t0)
    stored = sum(int(np.prod(store.by_key[k]["shape"]))
                 * np.dtype(store.by_key[k]["dtype"]).itemsize for k in keys)
    return dict(gbps=stored / statistics.median(times) / 1e9,
                out_gbps=got.nbytes / statistics.median(times) / 1e9,
                numpy_gbps=stored / statistics.median(numpy_times) / 1e9,
                times=times, threads=native.default_threads())


@contextlib.contextmanager
def watch_loader():
    """While open, the seconds every Loader's consumer spends waiting for
    its next batch are summed into the yielded list's one entry, and the
    batches counted in its second."""
    from vit_exp_tpu_torch.data.loader import Loader

    acc = [0.0, 0]
    inner = Loader.__iter__

    def iterate(self):
        it = inner(self)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            finally:
                acc[0] += time.perf_counter() - t0
            acc[1] += 1
            yield batch

    Loader.__iter__ = iterate
    try:
        yield acc
    finally:
        Loader.__iter__ = inner


def cls_phase(device, folder: Path, config: str, ckpts, tree, reports,
              labels, store_root, expected_int8: dict,
              expected_bf16: dict) -> dict:
    """``run_zero_shot_cls.main`` at full width: over the npz tree (int8),
    over the float16 store (int8 and --no-int8), and as a sweep of the two
    checkpoints over the store.  Each run's launches, counted over the
    call, are the serving path's per batch times its batches; the npz
    against the store's probabilities within PROB_TOL (the store holds
    float16); the sweep's second checkpoint bit for bit the fresh run on
    it.  Volumes/s and the loader's wait per batch of each run."""
    from vit_exp_tpu_torch.cli import run_zero_shot_cls

    base = ["--config", config, "--labels_csv", labels, "--reports_csv",
            reports, "--batch_size", str(CLS_BATCH)]
    npz = ["--data_folder", str(tree)]
    packed = ["--packed_root", str(store_root)]
    runs = {"npz, int8": (npz, [ckpts[1]], expected_int8),
            "packed, int8": (packed, [ckpts[1]], expected_int8),
            "packed, bf16": (packed + ["--no-int8"], [ckpts[1]],
                             expected_bf16),
            "packed, int8, sweep": (packed, list(ckpts), expected_int8)}
    out = {}
    for i, (tag, (data, paths, per_batch)) in enumerate(runs.items()):
        argv = base + data + ["--results_folder", str(folder / f"cls{i}")]
        for p in paths:
            argv += ["--model_path", p]
        with watch_loader() as wait:
            t0 = time.perf_counter()
            res, launches = count_launches(
                lambda: run_zero_shot_cls.main(argv, device=device))
            call_s = time.perf_counter() - t0
        n_batches = wait[1]
        want = {k: v * n_batches for k, v in per_batch.items()}
        last = list(res)[-1]
        pred = {name: np.load(folder / f"cls{i}" / name /
                              "predicted_weights.npz")["data"]
                for name in res}
        print(f"run_zero_shot_cls ({tag}): {len(pred[last])} volumes x "
              f"{len(res)} checkpoint(s) in {call_s:.3f} s, "
              f"{n_batches} batches; {res[last]['volumes_per_sec']:.3f} "
              f"volumes/s; mean AUROC {res[last]['mean_auc']:.4f} (random "
              f"data, printed only); loader wait {wait[0]:.3f} s in all; "
              f"launches {launches} (expected {want})", flush=True)
        check(launches == want, (tag, launches, want))
        check(all(np.isfinite(p).all() and p.shape[1] == 18
                  for p in pred.values()), tag)
        out[tag] = dict(res=res, pred=pred, launches=launches,
                        batches=n_batches, wait_s=wait[0], call_s=call_s)
    name = Path(ckpts[1]).name
    d_store = float(np.abs(out["npz, int8"]["pred"][name]
                           - out["packed, int8"]["pred"][name]).max())
    check(d_store <= PROB_TOL, ("npz against packed", d_store))
    sweep_same = np.array_equal(out["packed, int8, sweep"]["pred"][name],
                                out["packed, int8"]["pred"][name])
    check(sweep_same, "the sweep's second checkpoint against a fresh run")
    d_bf16 = float(np.abs(out["packed, bf16"]["pred"][name]
                          - out["packed, int8"]["pred"][name]).max())
    print(f"run_zero_shot_cls: npz against packed (float16) max |Δprob| "
          f"{d_store:.3e} (tolerance {PROB_TOL}); the sweep's "
          f"{name} bit for bit the fresh run's; int8 against bf16 max "
          f"|Δprob| {d_bf16:.3e} (printed only)", flush=True)
    return dict(runs=out, d_store=d_store, d_bf16=d_bf16)


def post(url: str, path: str, payload) -> tuple:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_phase(device, folder: Path, config: str, ckpt: str, store,
                expected_int8: dict, blocks: int, window_ms=None) -> dict:
    """``serve``'s server in-process on port 0 at its int8 default, loaded
    with ``ckpt`` and warmed at batch 1 and CLS_BATCH; the store's volumes
    written as .npy under --data_root.  Traffic: /health, SERVE_CLIENTS
    concurrent /classify_path clients of SERVE_ROUNDS requests each, then a
    lone request three times (batch-1 latency), one base64 /classify and
    one /embed.  Checks: the largest batch dispatched is CLS_BATCH; every
    served answer bit for bit a row predict_batch gives again on a batch
    the server dispatched (each batch's volumes are noted as it runs), and
    within PROB_TOL of predict_batch on its volume alone (the int8
    attention's one k scale over the batch moves a volume's probabilities
    with its companions: printed); each dispatch
    launched the int8 path's kernels once; the latent l2-normalised, of
    dim_latent entries.  Then where a batch's time goes: the host →
    device copy (from a page-locked stage, as the server's dispatcher
    stacks a batch, through the engine's side-stream copier), the tower,
    the read-back, on the engine.
    ``window_ms`` overrides the server's --batch_window_ms default (the CPU
    rehearsal's tiny engine answers before companions arrive)."""
    import base64
    import io
    import threading
    import urllib.request

    from vit_exp_tpu_torch.cli import serve

    root = folder / "served"
    root.mkdir()
    keys = store.keys()[:SERVE_CLIENTS]
    paths = []
    for i, k in enumerate(keys):
        paths.append(root / f"vol{i}.npy")
        np.save(paths[-1], store.get_f32(k))
    args = serve.parse_args(["--config", config, "--model_path", ckpt,
                             "--data_root", str(root)])
    engine, latent_fn, shape, channels = serve.build_service(args, device)
    warm_s = serve.warmup(engine, latent_fn, shape, channels, args.max_batch)
    # each dispatched batch: its volumes (by a fingerprint) and its output
    def mark(v):   # the central row of a (1, D, H, W) volume
        return v[0, v.shape[1] // 2, v.shape[2] // 2].tobytes()

    marks = {mark(np.load(q, mmap_mode="r")): i for i, q in enumerate(paths)}
    check(len(marks) == len(paths), "two volumes share a fingerprint")
    batches = []
    inner_predict = engine.predict_batch

    def predict(vols):
        out = inner_predict(vols)
        batches.append(([marks.get(mark(v)) for v in vols], out.copy()))
        return out

    engine.predict_batch = predict
    decode_ms = []
    inner_decode = serve._decode_volume

    def decode(*a, **kw):
        t0 = time.perf_counter()
        try:
            return inner_decode(*a, **kw)
        finally:
            decode_ms.append((time.perf_counter() - t0) * 1e3)

    serve._decode_volume = decode
    srv = serve.build_server(engine, latent_fn, shape, 0,
                             data_root=str(root), max_batch=args.max_batch,
                             window_ms=(args.batch_window_ms
                                        if window_ms is None else window_ms))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.loads(r.read())
        check(health["status"] == "ok" and len(health["pathologies"]) == 18,
              health)
        answers = [[None] * SERVE_ROUNDS for _ in range(SERVE_CLIENTS)]

        def client(i):
            for j in range(SERVE_ROUNDS):
                answers[i][j] = post(url, "/classify_path",
                                     {"path": str(paths[i])})

        decode_ms.clear()
        stats0 = dict(srv.batcher.stats)
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVE_CLIENTS)]

        def burst():
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=600)

        t0 = time.perf_counter()
        _, launches = count_launches(burst)
        burst_s = time.perf_counter() - t0
        check(not any(c.is_alive() for c in clients), "a client hung")
        burst_decode = list(decode_ms)
        stats = {k: srv.batcher.stats[k] - stats0.get(k, 0)
                 for k in ("dispatches", "volumes")}
        n = SERVE_CLIENTS * SERVE_ROUNDS
        check(stats["volumes"] == n and all(
            code == 200 for row in answers for code, _ in row),
            (stats, [code for row in answers for code, _ in row]))
        check(srv.batcher.stats["max_batch_seen"] == CLS_BATCH,
              ("max_batch_seen", srv.batcher.stats))
        want = {k: v * stats["dispatches"] for k, v in expected_int8.items()}
        check(launches == want, ("serve launches", launches, want))
        lone = []
        for _ in range(3):
            t1 = time.perf_counter()
            code, _ = post(url, "/classify_path", {"path": str(paths[0])})
            lone.append((time.perf_counter() - t1) * 1e3)
            check(code == 200, code)
        vol = np.load(paths[0])
        buf = io.BytesIO()
        np.save(buf, vol)
        b64 = base64.b64encode(buf.getvalue()).decode()
        code, cls_body = post(url, "/classify", {"volume": b64})
        check(code == 200, (code, cls_body))
        code, emb = post(url, "/embed", {"volume": b64})
        latent = np.asarray(emb.get("latent", []))
        dim = engine.model.to_visual_latent.weight.shape[0]
        check(code == 200 and latent.shape == (dim,)
              and abs(float(np.linalg.norm(latent)) - 1.0) < 1e-3,
              ("embed", code, latent.shape))
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
        serve._decode_volume = inner_decode
        del engine.predict_batch
    served = np.stack([[np.asarray([a[1]["probs"][p]
                                    for p in engine.pathologies])
                        for a in row] for row in answers])
    # replay every dispatched batch: the same bits again, and each served
    # answer one of its volume's rows
    rows = {i: [] for i in range(len(paths))}
    replayed = True
    for idx, out in batches:
        check(None not in idx, ("an unknown volume was dispatched", idx))
        again = engine.predict_batch(np.stack([np.load(paths[i])
                                               for i in idx]))
        replayed &= bool(np.array_equal(again, out))
        for i, row in zip(idx, out):
            rows[i].append(row.astype(np.float64))
    own_row = all(any(np.array_equal(a, r) for r in rows[i])
                  for i in range(len(paths)) for a in served[i])
    check(replayed and own_row, ("served against the dispatched batches",
                                 replayed, own_row))
    sizes = [len(idx) for idx, _ in batches]
    direct = np.stack([engine.predict_batch(np.load(p)[None])[0]
                       for p in paths])
    diff = float(np.abs(served - direct[:, None]).max())
    b64_diff = float(np.abs(np.asarray([cls_body["probs"][p] for p in
                                        engine.pathologies])
                            - direct[0]).max())
    check(diff <= PROB_TOL and b64_diff <= PROB_TOL, (diff, b64_diff))
    # where a batch's time goes, on the same engine
    from vit_exp_tpu_torch.data.pinned import PinnedPool

    stage = PinnedPool(1, ("image",), register=device.type == "cuda")
    first = np.load(paths[0])
    vols = stage.acquire(0).array("image", (CLS_BATCH,) + first.shape,
                                  first.dtype)
    for i, p in enumerate(paths[:CLS_BATCH]):
        vols[i] = np.load(p)
    parts = {"copy": [], "tower": [], "read": []}
    for _ in range(3):
        dev, s = timed(lambda: engine.feed.tensor(vols, "image"), device)
        parts["copy"].append(s)
        probs, s = timed(lambda: engine.probs(dev), device)
        parts["tower"].append(s)
        _, s = timed(lambda: probs.cpu().numpy(), device)
        parts["read"].append(s)
    del vols, dev
    stage.release(0)
    stage.close()
    release(device)
    return dict(vps=n / burst_s, burst_s=burst_s, stats=stats,
                max_batch_seen=srv.batcher.stats["max_batch_seen"],
                launches=launches, warm_s=warm_s, lone_ms=lone,
                decode_ms=burst_decode, diff=diff, b64_diff=b64_diff,
                sizes=sizes,
                bitwise=diff == 0.0 and b64_diff == 0.0,
                parts={k: statistics.median(v) * 1e3
                       for k, v in parts.items()},
                embed_dim=dim, blocks=blocks)


def real_data_phase(device, folder: Path, config: str, ckpts,
                    expected_int8: dict, expected_bf16: dict, blocks: int,
                    raw_hwd=CT_RAW_HWD, nifti_hwd=NIFTI_HWD,
                    dhw=CTRATE_DHW, window_ms=None) -> dict:
    """The five real-format phases in order: preprocessing, the CT-RATE
    files and the float16 store (pack_dataset), the native reader,
    run_zero_shot_cls, serve.  ``config`` and ``ckpts`` are the run_train
    phase's config and its two checkpoints."""
    from vit_exp_tpu_torch.cli import pack_dataset
    from vit_exp_tpu_torch.data.packed import PackedVolumeStore

    out = {"prep": prep_phase(device, folder, raw_hwd, nifti_hwd)}
    p = out["prep"]
    print(f"offline preprocessing of a {raw_hwd} int16 volume to "
          f"{p['shape']}: card {p['dev_s'] * 1e3:.3f} ms, CPU "
          f"{p['cpu_s'] * 1e3:.3f} ms, rel L2 {p['rel']:.3e} (tolerance "
          f"{PREP_RTOL}); preprocess_ctrate on {len(nifti_hwd)} NIfTI files "
          f"{ {k: round(v, 3) for k, v in p['cli_s'].items()} } s, card "
          f"against host rel L2 {p['cli_rel']:.3e}", flush=True)
    tree, reports, labels, names = ctrate_files(folder, dhw)
    t0 = time.perf_counter()
    pack_dataset.main(["--data_folder", str(tree), "--csv_file", reports,
                       "--out", str(folder / "store")])
    pack_s = time.perf_counter() - t0
    store = PackedVolumeStore(str(folder / "store"))
    check(sorted(store.keys()) == sorted(names), store.keys())
    out["pack_s"] = pack_s
    out["native"] = nat = native_phase(store)
    out["fs"] = filesystem_of(folder)
    print(f"files under {folder} on {out['fs']}; "
          f"packed {len(names)} volumes to float16 in {pack_s:.3f} s; "
          f"native get_batch of {CLS_BATCH}: {nat['gbps']:.3f} GB/s stored, "
          f"{nat['out_gbps']:.3f} GB/s fp32 out ({nat['threads']} threads, "
          f"{[round(t, 4) for t in nat['times']]} s); memmap and numpy "
          f"{nat['numpy_gbps']:.3f} GB/s stored", flush=True)
    out["cls"] = cls_phase(device, folder, config, ckpts, tree, reports,
                           labels, folder / "store", expected_int8,
                           expected_bf16)
    shutil.rmtree(tree)
    out["serve"] = s = serve_phase(device, folder, config, ckpts[1], store,
                                   expected_int8, blocks, window_ms)
    store.close()
    print(f"serve (int8, {SERVE_CLIENTS} clients x {SERVE_ROUNDS} "
          f"/classify_path): {s['vps']:.3f} volumes/s over {s['burst_s']:.3f}"
          f" s, {s['stats']['dispatches']} dispatches, max batch "
          f"{s['max_batch_seen']}; launches per dispatch "
          f"{ {k: v // s['stats']['dispatches'] for k, v in s['launches'].items() if v} }; "
          f"lone request {[round(t, 3) for t in s['lone_ms']]} ms; "
          f"server-side decode median {statistics.median(s['decode_ms']):.3f}"
          f" ms; dispatched batch sizes {s['sizes']}, every answer bit for "
          f"bit predict_batch's on its batch; against predict_batch on the "
          f"volume alone max |Δprob| {s['diff']:.3e}, base64 "
          f"{s['b64_diff']:.3e} (tolerance {PROB_TOL}"
          f"{'; bit for bit' if s['bitwise'] else ''}); a batch of "
          f"{CLS_BATCH}: copy {s['parts']['copy']:.3f} ms, tower "
          f"{s['parts']['tower']:.3f} ms, read-back {s['parts']['read']:.3f}"
          f" ms; warm-up {s['warm_s']:.3f} s", flush=True)
    return out


def real_data_lines(real: dict, card: str) -> list:
    """The real-format phases' result lines, each on the card."""
    p, nat, s = real["prep"], real["native"], real["serve"]
    lines = [f"offline preprocessing, {CT_RAW_HWD} int16 to {p['shape']}: "
             f"card {p['dev_s'] * 1e3:.3f} ms, CPU {p['cpu_s'] * 1e3:.3f} ms "
             f"(rel L2 {p['rel']:.3e}) on {card}",
             f"native packed reader, {CLS_BATCH} float16 records on "
             f"{real['fs']}: "
             f"{nat['gbps']:.3f} GB/s read ({nat['out_gbps']:.3f} GB/s fp32 "
             f"out, {nat['threads']} threads; memmap and numpy "
             f"{nat['numpy_gbps']:.3f}) on {card}"]
    for tag, r in real["cls"]["runs"].items():
        last = list(r["res"])[-1]
        lines.append(
            f"run_zero_shot_cls ({tag}), batch {CLS_BATCH}: "
            f"{r['res'][last]['volumes_per_sec']:.3f} volumes/s, loader "
            f"wait {r['wait_s'] / r['batches']:.3f} s per batch, "
            f"{r['call_s']:.3f} s for the call on {card}")
    dec = s["decode_ms"]
    lines.append(
        f"serve, int8, {SERVE_CLIENTS} concurrent clients x {SERVE_ROUNDS} "
        f"/classify_path: {s['vps']:.3f} volumes/s; lone request "
        f"{statistics.median(s['lone_ms']):.3f} ms (median of 3); "
        f"server-side decode {statistics.median(dec):.3f} ms (median, "
        f"max {max(dec):.3f}); a batch of {CLS_BATCH}: host->device copy "
        f"{s['parts']['copy']:.3f} ms, tower {s['parts']['tower']:.3f} ms, "
        f"read-back {s['parts']['read']:.3f} ms on {card}")
    return lines


# real-format training at full width: copies of three production configs
# whose data paths point at generated files (a CT-RATE npz tree, a RadGenome
# image and mask tree with its label table, a float16 packed store), each
# trained REAL_TRAIN_STEPS optimizer steps by run_train.main; the first
# REAL_TRAIN_CHECKED batches of each loader are kept on the device and held
# byte for byte to the data set's batch of the same indices; then
# run_zero_shot_seg on the RadGenome folders and run_latents on the CT-RATE
# tree, each against the engine's own in-memory result
REAL_TRAIN_CONFIGS = {"ct_clip_vit_open_seg.yaml": OPEN_SEG_CONFIG,
                      "ct_clip_vit_seg.yaml": SEG_CONFIG,
                      "prod_sustained_synth.yaml": RUN_TRAIN_CONFIG}
REAL_TRAIN_STEPS, REAL_TRAIN_CHECKED = 3, 3
# the seg and open-seg loaders' workers in the copies: each item holds a
# 4.87 GB fp32 mask (22 × 240 × 480 × 480); at the configs' 4 workers (4 +
# 2 prefetched items, ≈ 30 GB, beside 3 page-locked slots of 5.1 GB and the
# image-report loader's 8 workers) the card's host (≈ 100 GiB) ran the
# steps several times slower (PERF.md §6, PR 14)
REAL_SEG_WORKERS = 2
RADGENOME_N, RADGENOME_DHW = 2, (240, 480, 480)
STORE_N, STORE_SHAPE = 8, (240, 480, 480)
COPY_REPEATS = 3


def mem_total_gb() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def radgenome_files(folder: Path, n_classes: int, n=RADGENOME_N,
                    dhw=RADGENOME_DHW, seed=23):
    """RadGenome's layout: ``images/case_{i}.npz`` (D, H, W) float32,
    pre-cropped, and ``masks/case_{i}.npz`` (n_classes, D, H, W) uint8,
    compressed (mostly zeros: one box a class), with ``label_names.csv``
    naming the classes.  Returns (images, masks, table)."""
    r = np.random.default_rng(seed)
    images, masks = folder / "radgenome" / "images", folder / "radgenome" / \
        "masks"
    images.mkdir(parents=True)
    masks.mkdir(parents=True)
    for i in range(n):
        vol = r.standard_normal(dhw, dtype=np.float32)
        np.clip(vol * np.float32(0.4), -1.2, 1.2, out=vol)
        np.savez(images / f"case_{i}.npz", vol)
        del vol
        mask = np.zeros((n_classes,) + tuple(dhw), np.uint8)
        for c in range(n_classes):
            lo = [int(r.integers(0, s // 2)) for s in dhw]
            hi = [a + int(r.integers(s // 8, s // 2)) for a, s in
                  zip(lo, dhw)]
            mask[c, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = 1
        np.savez_compressed(masks / f"case_{i}.npz", mask)
        del mask
    table = folder / "radgenome" / "label_names.csv"
    table.write_text("ID,NAME\n" + "".join(
        f"{c + 1},organ {c + 1}\n" for c in range(n_classes)))
    return str(images), str(masks), str(table)


def synth_store(folder: Path, n=STORE_N, shape=STORE_SHAPE) -> str:
    """The float16 store of scripts/make_synth_shards_torch.py."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_synth_shards_torch",
        ROOT / "scripts" / "make_synth_shards_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script.main(["--out", str(folder / "synth_packed"), "--n", str(n),
                        "--shape", ",".join(map(str, shape))])


def real_train_config(folder: Path, name: str, paths: dict, n_classes: int,
                      overrides=None) -> str:
    """A copy of configs/``name`` whose data paths are ``paths``' (the
    imagereport entries the CT-RATE tree or, packed, the store; the seg and
    open-seg entries the RadGenome folders and label table, with
    REAL_SEG_WORKERS loader workers; ``valid_data``
    cls the CT-RATE tree, for a config whose hooks name it) and whose
    results go to ``folder``/stem.  ``overrides`` replaces top-level keys
    (the CPU rehearsal's tiny arch), and a seg head takes ``n_classes``
    (the config's own 22 on the card).  Returns the written path."""
    import yaml

    cfg = yaml.safe_load(REAL_TRAIN_CONFIGS[name].read_text())
    stem = name.removesuffix(".yaml")
    cfg["results_folder"] = str(folder / stem)
    for spec in cfg["train_data_list"]:
        kind = spec.get("type", "imagereport")
        if kind == "imagereport" and spec.get("packed"):
            spec["data_folder"] = paths["store"]
        elif kind == "imagereport":
            spec.update(data_folder=paths["tree"],
                        reports_csv=paths["reports"])
        else:
            spec.update(data_folder=paths["images"],
                        mask_folder=paths["masks"],
                        num_workers=REAL_SEG_WORKERS)
            if kind == "imageopenseg":
                spec["seg_mask_name_table"] = paths["table"]
    if cfg.get("valid_test_list"):
        cfg["valid_data"] = {"cls": {"data_folder": paths["tree"],
                                     "reports_csv": paths["reports"],
                                     "labels_csv": paths["labels"]}}
    cfg.update(overrides or {})
    head = (cfg.get("ct_clip_arch") or {}).get("seg_head")
    if head:
        head["out_dim"] = n_classes
    path = folder / f"{stem}.yaml"
    path.write_text(json.dumps(cfg))   # JSON is YAML
    return str(path)


@contextlib.contextmanager
def keep_device_batches(per_loader: int):
    """While open, every CTClipTrainer keeps the device batches of the
    first ``per_loader`` micro-steps of each data set (their tensors, as
    the step function got them).  Yields {data set: [batch, ...]}."""
    from vit_exp_tpu_torch.train.trainer import CTClipTrainer

    kept = {}
    inner = CTClipTrainer._device_batch

    def device_batch(self, ds_idx):
        out = inner(self, ds_idx)
        if len(kept.setdefault(ds_idx, [])) < per_loader:
            kept[ds_idx].append(out)
        return out

    CTClipTrainer._device_batch = device_batch
    try:
        yield kept
    finally:
        CTClipTrainer._device_batch = inner


@contextlib.contextmanager
def profile_step(step: int, path: Path, what: str):
    """While open, every CTClipTrainer's step ``step`` runs under
    ``profile_call`` on a card (its logs returned as they are).  Yields a
    dict that gets "wall_ms" and "busy_ms" (on a card) and "end", the
    host clock when that step's work has finished."""
    from vit_exp_tpu_torch.train.trainer import CTClipTrainer

    out = {}
    inner = CTClipTrainer.train_step

    def train_step(self):
        if self.step + 1 != step:
            return inner(self)
        box = {}

        def run():
            box["logs"] = inner(self)

        if self.device.type == "cuda":
            out["wall_ms"], out["busy_ms"] = profile_call(run, path, what)
        else:
            run()
        out["end"] = time.perf_counter()
        return box["logs"]

    CTClipTrainer.train_step = train_step
    try:
        yield out
    finally:
        CTClipTrainer.train_step = inner


def loader_batch(trainer, ds_idx: int, j: int) -> dict:
    """The data set's ``j``-th batch as the trainer's loader draws it
    (epoch j // its length), made anew in plain memory."""
    from vit_exp_tpu_torch.data.loader import Loader

    live = trainer.loaders[ds_idx].loader
    fresh = Loader(live.dataset, live.batch_size, shuffle=live.shuffle,
                   seed=live.seed, drop_last=live.drop_last)
    fresh.epoch = j // len(fresh)
    return fresh.load_batch(fresh._batch_indices()[j % len(fresh)])


def copy_times(device, host: dict, keys) -> dict:
    """One batch's host → device copy: through a page-locked buffer and
    the side-stream copier (the trainer's way), and by a pageable
    ``.to()`` of the same bytes; median ms of COPY_REPEATS each, and the
    bytes."""
    from vit_exp_tpu_torch.data.pinned import (BatchCopier, HostBatch,
                                               PinnedPool)

    keys = [k for k in keys if isinstance(host.get(k), np.ndarray)]
    pool = PinnedPool(1, keys, register=device.type == "cuda")
    copier = BatchCopier(device)
    pinned_ms, pageable_ms = [], []
    try:
        for i in range(COPY_REPEATS):
            slot = pool.acquire(i)
            batch = HostBatch({k: slot.array(k, host[k].shape, host[k].dtype)
                               for k in keys})
            for k in keys:
                np.copyto(batch[k], host[k])
            batch.release = lambda event=None, i=i: pool.release(i, event)
            _, t = timed(lambda: copier.to_device(batch, keys), device)
            pinned_ms.append(t * 1e3)
            _, t = timed(lambda: {k: torch.from_numpy(host[k]).to(device)
                                  for k in keys}, device)
            pageable_ms.append(t * 1e3)
    finally:
        pool.close()
    return dict(pinned_ms=statistics.median(pinned_ms),
                pageable_ms=statistics.median(pageable_ms),
                bytes=sum(host[k].nbytes for k in keys))


def hold_batches(device, trainer, kept: dict) -> dict:
    """Each kept device batch against the data set's batch of the same
    indices, byte for byte (ids as int64); then the first batch of each
    data set's copy times.  Returns ({type: batches held}, {type: copy
    times})."""
    from vit_exp_tpu_torch.train.trainer import _BATCH_KEYS, _ID_KEYS

    held, copies = {}, {}
    for ds_idx, batches in kept.items():
        kind = trainer.data_types[ds_idx]
        for j, dev in enumerate(batches):
            host = loader_batch(trainer, ds_idx, j)
            for k, v in dev.items():
                want = torch.from_numpy(np.ascontiguousarray(host[k]))
                want = want.long() if k in _ID_KEYS else want
                check(v.dtype == want.dtype and v.shape == want.shape
                      and torch.equal(v, want.to(device)),
                      (kind, "micro-step batch", j, k, "differs from the "
                       "loader's batch of the same indices"))
            held[kind] = held.get(kind, 0) + 1
            if j == 0:
                copies[kind] = copy_times(device, host, _BATCH_KEYS)
            del host
    return held, copies


def real_train_run(device, folder: Path, name: str, paths: dict,
                   per_micro: dict, n_classes: int, overrides=None,
                   steps=REAL_TRAIN_STEPS, checked=REAL_TRAIN_CHECKED):
    """``run_train.main`` on the copy of configs/``name`` for ``steps``
    optimizer steps with the first ``checked`` device batches of each
    loader kept and held byte for byte (``hold_batches``); finite losses
    at every step; the launches of each step type in the last step
    (``per_micro`` per micro-step), which is also profiled; steps/s and
    loader wait per batch from the start of step 2 to the end of the
    last; the final checkpoint reloaded bit for bit.  Returns the
    numbers; the trainer's checkpoint directory stays."""
    from vit_exp_tpu_torch.cli import run_train

    cfg = real_train_config(folder, name, paths, n_classes, overrides)
    argv = ["--config", cfg, "--debug"]
    stem = name.removesuffix(".yaml")
    with watch_micro_steps(steps) as (marks, by_type), \
            keep_device_batches(checked) as kept, \
            profile_step(steps, OUT_DIR / f"profile_real_{stem}.txt",
                         f"run_train step {steps} of the {name} copy") as prof:
        t0 = time.perf_counter()
        tr = run_train.main(argv + ["--steps", str(steps)], device=device)
        call_s = time.perf_counter() - t0
    lines = read_metrics(folder / stem)
    print(f"run_train {name}: {call_s:.3f} s for the call; step_time_s "
          f"{[round(d.get('step_time_s', math.nan), 3) for d in lines]}; "
          f"(step, s, loader wait s, batches) at each step's start "
          f"{[(m[0], round(m[1] - t0, 3), round(m[2], 3), m[3]) for m in marks]}",
          flush=True)
    losses = {k: [d[k] for d in lines if k in d] for k in lines[-1]
              if k.startswith("ds") and k.endswith("_loss")}
    check(tr.status == "completed" and tr.step == steps
          and [d["step"] for d in lines] == list(range(1, steps + 1))
          and all(len(v) == steps and all(map(math.isfinite, v))
                  for v in losses.values()), (name, lines))
    acc = tr.sampler.sample(steps - 1)
    want = {}
    for ds_idx, n in enumerate(acc):
        kind = tr.data_types[ds_idx]
        want[kind] = {k: v * int(n) for k, v in per_micro.items()}
    print(f"run_train {name}: launches by step type in step {steps} "
          f"{by_type} (expected {want})", flush=True)
    check(by_type == want, (name, by_type, want))
    _, t_a, w_a, b_a = marks[1]
    out = dict(config=cfg, types=list(tr.data_types), call_s=call_s,
               steps=tr.step, losses=losses, by_type=by_type,
               sps=(steps - 1) / (prof["end"] - t_a),
               wait_s=(tr.data_wait_s - w_a) / max(tr.batches - b_a, 1),
               step_times=[d["step_time_s"] for d in lines],
               workers={t: s.get("num_workers", 4) for t, s in zip(
                   tr.data_types, tr.config.train_data_list)})
    out.update({k: prof[k] for k in ("wall_ms", "busy_ms") if k in prof})
    ended = trainer_state(tr)   # the state the final checkpoint holds
    out["checked"], out["copy_ms"] = hold_batches(device, tr, kept)
    kept.clear()
    out["ckpt_dir"] = tr.ckpt.directory
    tr.close()
    del tr
    release(device)
    restored = run_train.make_trainer(
        run_train.parse_args(argv + ["--auto_resume"]), device)
    same = restored.step == steps and state_equal(trainer_state(restored),
                                                  ended)
    del restored, ended
    release(device)
    check(same, (name, "the reloaded checkpoint differs from the state "
                       "the run saved"))
    return out


def seg_folders_phase(device, folder: Path, config: str, ckpt: str,
                      paths: dict, per_volume: dict) -> dict:
    """``run_zero_shot_seg.main`` at its int8 default on the RadGenome
    folders with ``ckpt``: its launches (``per_volume`` a volume), finite
    dice; then its engine's ``infer`` on the same arrays read into memory:
    the same result, bit for bit."""
    from vit_exp_tpu_torch.cli import run_zero_shot_seg
    from vit_exp_tpu_torch.data.datasets import CTSegDataset
    from vit_exp_tpu_torch.eval.zero_shot import ZeroShotSegmenter

    engines = []
    inner = ZeroShotSegmenter.infer

    def infer(self, *a, **kw):
        engines.append(self)
        return inner(self, *a, **kw)

    ZeroShotSegmenter.infer = infer
    try:
        t0 = time.perf_counter()
        res, launches = count_launches(lambda: run_zero_shot_seg.main(
            ["--config", config, "--model_path", ckpt, "--data_folder",
             paths["images"], "--mask_folder", paths["masks"],
             "--results_folder", str(folder / "seg_folders")],
            device=device))
        call_s = time.perf_counter() - t0
    finally:
        ZeroShotSegmenter.infer = inner
    ds = CTSegDataset(paths["images"], paths["masks"])
    want = {k: v * len(ds) for k, v in per_volume.items()}
    check(launches == want, ("run_zero_shot_seg on folders", launches, want))
    check(all(math.isfinite(v) for v in res.values()), res)
    memory = [ds[i] for i in range(len(ds))]
    again = engines[0].infer(memory)
    del memory, engines
    release(device)
    check(again == res, ("run_zero_shot_seg on folders against the engine "
                         "on the same arrays in memory", res, again))
    return dict(res=res, memory=again, launches=launches, call_s=call_s,
                volumes=len(ds))


def latents_phase(device, folder: Path, config: str, ckpt: str,
                  paths: dict, per_batch: dict) -> dict:
    """``run_latents.main`` at its int8 default on the CT-RATE tree with
    ``ckpt``: its launches (``per_batch`` a batch), the summary line; its
    image latents bit for bit the engine's own
    image_latents_from_tokens(encode_image_tokens(·)) on the same batches
    of the data set's volumes."""
    from vit_exp_tpu_torch.cli import run_latents
    from vit_exp_tpu_torch.data.datasets import CTReportInferenceDataset
    from vit_exp_tpu_torch.eval import latents

    engines = []
    inner = latents.dump_latents

    def dump(engine, *a, **kw):
        engines.append(engine)
        return inner(engine, *a, **kw)

    latents.dump_latents = dump
    out_dir = folder / "latents"
    try:
        t0 = time.perf_counter()
        summary, launches = count_launches(lambda: run_latents.main(
            ["--config", config, "--model_path", ckpt, "--data_folder",
             paths["tree"], "--reports_csv", paths["reports"],
             "--labels_csv", paths["labels"], "--results_folder",
             str(out_dir)], device=device))
        call_s = time.perf_counter() - t0
    finally:
        latents.dump_latents = inner
    engine = engines.pop()
    ds = CTReportInferenceDataset(paths["tree"], paths["reports"],
                                  paths["labels"])
    bs = engine.batch_size
    n_batches = -(-len(ds) // bs)
    want = {k: v * n_batches for k, v in per_batch.items()}
    check(launches == want, ("run_latents", launches, want))
    dumped = np.load(out_dir / "latents.npz")["image_latents"]
    model = engine.model
    model.eval()
    mine = []
    with torch.inference_mode():
        for i in range(0, len(ds), bs):
            video = torch.as_tensor(np.stack(
                [ds[j]["image"] for j in range(i, min(i + bs, len(ds)))]),
                device=device)
            mine.append(model.image_latents_from_tokens(
                model.encode_image_tokens(video)).float().cpu().numpy())
    mine = np.concatenate(mine)
    bitwise = mine.shape == dumped.shape and np.array_equal(mine, dumped)
    check(bitwise and np.isfinite(dumped).all(),
          ("run_latents against the engine's encoders", mine.shape,
           dumped.shape))
    del engine, model
    release(device)
    return dict(summary=summary, launches=launches, call_s=call_s,
                bitwise=bitwise, batches=n_batches)


def real_training_phase(device, folder: Path, train_per_micro: dict,
                        seg_int8_per_volume: dict, int8_per_batch: dict,
                        overrides=None, ctrate_dhw=CTRATE_DHW,
                        radgenome_dhw=RADGENOME_DHW, store_shape=STORE_SHAPE,
                        n_classes=None) -> dict:
    """The files (a CT-RATE tree, the RadGenome tree, the synthetic store),
    then ``real_train_run`` on each of REAL_TRAIN_CONFIGS, then
    ``seg_folders_phase`` on the seg run's checkpoint and
    ``latents_phase`` on the packed run's.  ``n_classes`` defaults to the
    seg config's 22."""
    if n_classes is None:
        n_classes = load_seg_config(SEG_CONFIG).ct_clip_arch.seg_head.out_dim
    t0 = time.perf_counter()
    tree, reports, labels, _ = ctrate_files(folder, ctrate_dhw)
    images, masks, table = radgenome_files(folder, n_classes,
                                           dhw=radgenome_dhw)
    store = synth_store(folder, shape=store_shape)
    paths = dict(tree=str(tree), reports=reports, labels=labels,
                 images=images, masks=masks, table=table, store=store)
    out = dict(write_s=time.perf_counter() - t0, mem_gb=mem_total_gb(),
               runs={})
    print(f"real-format training files written in {out['write_s']:.3f} s "
          f"(CT-RATE tree, RadGenome {RADGENOME_N} cases x {n_classes} "
          f"classes, store of {STORE_N}); host MemTotal "
          f"{out['mem_gb']:.1f} GiB", flush=True)
    for name in REAL_TRAIN_CONFIGS:
        r = out["runs"][name] = real_train_run(
            device, folder, name, paths, train_per_micro, n_classes,
            overrides)
        copies = "; ".join(
            f"{t}: pinned {c['pinned_ms']:.3f} ms "
            f"({c['bytes'] / c['pinned_ms'] / 1e6:.3f} GB/s), pageable "
            f"{c['pageable_ms']:.3f} ms" for t, c in r["copy_ms"].items())
        print(f"run_train {name} ({REAL_TRAIN_STEPS} steps, num_workers "
              f"{r['workers']}): {r['sps']:.3f} steps/s, loader wait "
              f"{r['wait_s']:.3f} s per batch; losses "
              f"{ {k: [round(x, 5) for x in v] for k, v in r['losses'].items()} }; "
              f"batches held byte for byte {r['checked']}; a batch's copy "
              f"{copies}; checkpoint reloaded bit for bit", flush=True)
    stems = {n: n.removesuffix(".yaml") for n in REAL_TRAIN_CONFIGS}
    seg = out["runs"]["ct_clip_vit_seg.yaml"]
    out["seg"] = s = seg_folders_phase(device, folder, seg["config"],
                                       seg["ckpt_dir"], paths,
                                       seg_int8_per_volume)
    print(f"run_zero_shot_seg (int8) on the RadGenome folders, "
          f"{s['volumes']} volumes: {s['res']} in {s['call_s']:.3f} s, "
          f"launches {s['launches']}; the engine on the same arrays in "
          f"memory bit for bit", flush=True)
    packed = out["runs"]["prod_sustained_synth.yaml"]
    out["latents"] = lt = latents_phase(device, folder, packed["config"],
                                        packed["ckpt_dir"], paths,
                                        int8_per_batch)
    print(f"run_latents (int8) on the CT-RATE tree: {lt['summary']} in "
          f"{lt['call_s']:.3f} s, {lt['batches']} batches, launches "
          f"{lt['launches']}; image latents bit for bit the engine's own "
          f"encoders", flush=True)
    for stem in stems.values():
        shutil.rmtree(folder / stem, ignore_errors=True)
    return out


def real_training_lines(out: dict, card: str) -> list:
    """The real-format training phases' result lines, each on the card."""
    lines = []
    for name, r in out["runs"].items():
        busy = ""
        if "wall_ms" in r:
            busy = (f"; step {REAL_TRAIN_STEPS} profiled: wall "
                    f"{r['wall_ms']:.3f} ms, "
                    f"device busy {r['busy_ms']:.3f} ms, idle share "
                    f"{1 - r['busy_ms'] / r['wall_ms']:.3f}")
        copies = "; ".join(
            f"{t} batch {c['bytes'] / 1e6:.1f} MB: pinned side-stream copy "
            f"{c['pinned_ms']:.3f} ms ({c['bytes'] / c['pinned_ms'] / 1e6:.3f}"
            f" GB/s), pageable .to() {c['pageable_ms']:.3f} ms "
            f"({c['bytes'] / c['pageable_ms'] / 1e6:.3f} GB/s)"
            for t, c in r["copy_ms"].items())
        lines.append(
            f"run_train on a copy of {name} over generated files "
            f"({REAL_TRAIN_STEPS} steps, num_workers {r['workers']}): "
            f"{r['sps']:.3f} steps/s and loader wait {r['wait_s']:.3f} s "
            f"per batch from the start of step 2 to the end of step "
            f"{REAL_TRAIN_STEPS}{busy}; {copies}; host MemTotal "
            f"{out['mem_gb']:.1f} GiB on {card}")
    s, lt = out["seg"], out["latents"]
    lines.append(f"run_zero_shot_seg (int8) on the RadGenome folders: "
                 f"{s['volumes']} volumes in {s['call_s']:.3f} s, mean dice "
                 f"{s['res']['mean_dice']:.4f} on {card}")
    lines.append(f"run_latents (int8) on the CT-RATE tree: "
                 f"{lt['summary']['n']} volumes in {lt['call_s']:.3f} s, "
                 f"report-to-volume recall@5 "
                 f"{lt['summary']['report_to_volume_recall_at_k']:.4f} "
                 f"(random data, printed only) on {card}")
    return lines



# the auxiliary training branches: the image-report step with the MLM and
# visual-SSL terms (simsiam, then simclr) at full width, batch 4,
# attn_impl="pallas"; run_train on an SSL copy of prod_sustained_synth;
# run_finetune lipro (batch 2, the CLI's default) and vocabfine (batch 1,
# 36 prompts of 512 tokens) with the export scored by run_zero_shot_cls;
# run_text_classifier (BERT-base, 512 tokens, batch 32) on generated CSVs
SSL_TYPES = ("simsiam", "simclr")
LIPRO_BATCH, LIPRO_VOLUMES, LIPRO_FIT_STEPS = 2, 8, 20
VOCABFINE_VOLUMES = 2
TEXT_REPORTS, TEXT_BATCH, TEXT_LEN_CLS = 256, 32, 512
TEXT_WORDS = ("no", "pleural", "effusion", "mild", "cardiomegaly", "nodule",
              "in", "the", "right", "left", "upper", "lobe", "atelectasis",
              "is", "seen", "consolidation", "emphysema", "normal", "heart",
              "size", "opacity", "bronchiectasis", "with", "and")


def ssl_config(ssl_type: str, arch=ARCH, seed: int = 0):
    """A config for the image-report step with both self-supervision terms
    at their default weights (0.05 each)."""
    from vit_exp_tpu_torch.core.config import CTClipArchConfig

    return types.SimpleNamespace(
        arch=types.SimpleNamespace(**arch), random_seed=seed,
        ct_clip_arch=CTClipArchConfig(use_mlm=True, use_visual_ssl=True,
                                      visual_ssl_type=ssl_type))


def ssl_step_grads(trainer, batch, draws):
    """One step with the given draws: (metrics, pre-clip global grad norm,
    the names of the parameters given a nonzero gradient)."""
    model, opt, step = trainer
    metrics = {k: float(v) for k, v in step(batch, 1.0, draws=draws).items()}
    return metrics, float(opt.grad_norm), {
        n for n, p in model.named_parameters()
        if p.grad is not None and bool(p.grad.abs().max() > 0)}


def rel_to(a: float, b: float) -> float:
    """|a − b| over max(|b|, 1): relative for terms of order one and above,
    absolute below (the SimSiam term is a cosine, near 0 at random
    weights)."""
    return abs(a - b) / max(abs(b), 1.0)


def ssl_phase(device, bert_config, ssl_type: str, expected, arch=ARCH,
              batch_size=BATCH, text_len=TEXT_LEN, timed=3, profile=True):
    """The image-report step with both terms, from one seeded state on one
    batch with the draws of step 0 fixed: one step on plain and one on the
    kernels (its launches counted, its peak device memory read); the
    loss and each term within LOSS_RTOL (rel_to), the global gradient norm
    within GRAD_NORM_RTOL, every parameter plain gives a gradient gets one
    from the kernels, the SSL heads and mlm_head among them.  Then
    ``timed`` warm steps (their own draws) and, with ``profile``, one
    profiled step.  Returns the numbers."""
    from vit_exp_tpu_torch.train.steps import step_draws

    config = ssl_config(ssl_type, arch)
    kern = build_seg_trainer(device, config, bert_config, "imagereport")
    plain = build_seg_trainer(device, config, bert_config, "imagereport",
                              use_kernels=False,
                              state_dict=kern[0].state_dict())
    batch = train_batch(device, arch, bert_config.vocab_size, batch_size,
                        text_len)
    draws = step_draws(0, 0, batch["input_ids"].shape,
                       bert_config.vocab_size, mlm=True, ssl=True)
    mp, np_, sp = ssl_step_grads(plain, batch, draws)
    del plain
    release(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    (mk, nk, sk), launches = count_launches(
        lambda: ssl_step_grads(kern, batch, draws))
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if device.type == "cuda" else float("nan"))
    dterms = {k: rel_to(mk[k], mp[k]) for k in mp}
    dnorm = abs(nk - np_) / np_
    missing = sorted(sp - sk)
    heads = {"mlm_head.weight", "ssl_projector.fc0.weight",
             "ssl_projector.out.weight"}
    if ssl_type == "simsiam":
        heads |= {"ssl_predictor.fc0.weight", "ssl_predictor.fc1.weight"}
    tag = f"SSL step ({ssl_type})"
    print(f"{tag} at full width, batch {batch_size}, attn_impl=pallas: "
          f"kernels {mk}, plain {mp} (|Δ| / max(|plain|, 1): "
          f"{ {k: f'{v:.3e}' for k, v in dterms.items()} }, tolerance "
          f"{LOSS_RTOL}); grad norm kernels {nk:.6f}, plain {np_:.6f} (rel "
          f"{dnorm:.3e}, tolerance {GRAD_NORM_RTOL}); parameters without a "
          f"kernel-path gradient: {missing}; peak device memory of the "
          f"kernel step {peak_gb:.3f} GB", flush=True)
    print(f"launches in one {tag}: {launches} (expected {expected})",
          flush=True)
    check(set(mk) == {"cl_loss", "text_ssl_loss", "image_ssl_loss", "loss"}
          and all(math.isfinite(v) for v in (*mk.values(), *mp.values()))
          and max(dterms.values()) <= LOSS_RTOL, (tag, mk, mp))
    check(dnorm <= GRAD_NORM_RTOL, (tag, dnorm))
    check(sp and not missing and heads <= sk, (tag, missing, heads - sk))
    check(expected is None or launches == expected, (tag, launches))
    model, _, step = kern
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        float(step(batch, 1.0)["loss"])
        times.append(time.perf_counter() - t0)
    out = dict(launches=launches, metrics=mk, dterms=dterms, dnorm=dnorm,
               peak_gb=peak_gb, times=times)
    if profile and device.type == "cuda":
        out["wall_ms"], out["busy_ms"] = profile_call(
            lambda: float(step(batch, 1.0)["loss"]),
            OUT_DIR / "profile_ssl.txt", f"one {tag}")
    del kern, model, step, batch
    release(device)
    return out


def ssl_run_train_phase(device, folder: Path, expected, overrides=None,
                        synthetic=8):
    """``run_train.main`` on an SSL copy of prod_sustained_synth (simsiam,
    both terms): 2 steps; a trainer restored with --auto_resume held bit
    for bit to the state the run ended with (the optimizer's micro-step
    count, from which the draws come, included); --auto_resume to 3, whose
    step 3 launches are counted.  Checks finite cl_loss, text_ssl_loss and
    image_ssl_loss at every step."""
    from vit_exp_tpu_torch.cli import run_train

    ca = {"use_mlm": True, "use_visual_ssl": True,
          "visual_ssl_type": "simsiam"}
    cfg = run_train_config(folder, "ssl_run",
                           {"ct_clip_arch": ca, **(overrides or {})})
    base = ["--config", cfg, "--synthetic", str(synthetic), "--debug"]
    t0 = time.perf_counter()
    t1 = run_train.main(base + ["--steps", "2"], device=device)
    first_s = time.perf_counter() - t0
    check(t1.status == "completed" and t1.step == 2
          and t1.optimizer.count == 2, (t1.status, t1.step))
    ended = trainer_state(t1)
    del t1
    release(device)
    restored = run_train.make_trainer(
        run_train.parse_args(base + ["--auto_resume"]), device)
    same = (restored.step == 2 and restored.optimizer.count == 2
            and state_equal(trainer_state(restored), ended))
    restored.close()
    del restored, ended
    release(device)
    check(same, "an SSL trainer restored from ckpt_2 differs from the state "
                "the first run saved")
    with watch_steps(3) as (_, launches):
        t2 = run_train.main(base + ["--auto_resume", "--steps", "3"],
                            device=device)
    check(t2.status == "completed" and t2.step == 3, (t2.status, t2.step))
    t2.close()
    del t2
    release(device)
    lines = read_metrics(folder / "ssl_run")
    keys = ("ds0_cl_loss", "ds0_text_ssl_loss", "ds0_image_ssl_loss")
    check([d["step"] for d in lines] == [1, 2, 3]
          and all(math.isfinite(d[k]) for d in lines for k in keys), lines)
    print(f"run_train SSL copy: losses "
          f"{[{k[4:]: round(d[k], 5) for k in keys} for d in lines]}; "
          f"restored at step 2 bit for bit; launches of step 3 "
          f"{dict(launches)} (expected {expected})", flush=True)
    check(expected is None or launches == expected, launches)
    shutil.rmtree(folder / "ssl_run")
    return dict(lines=lines, launches=dict(launches), first_s=first_s)


def lipro_cases(device, arch=ARCH, batch=LIPRO_BATCH, seed=30):
    """The probe's frozen-tower rows at its batch: K15 without lse, K2's
    three stages and the patch embedding (forward only)."""
    cases = ([c for c in online_kernel_cases(device, arch, batch, seed)
              if c.counter == "K15" and "lse" not in c.name]
             + [c for c in kernel_cases(device, arch, batch, seed + 1)
                if c.counter in ("K2x", "K2h", "K2o", "K4")])
    for case in cases:
        case.name += f" (lipro, batch {batch})"
    return cases


def lipro_phase(device, folder: Path, per_batch, overrides=None,
                n=LIPRO_VOLUMES, fit_steps=LIPRO_FIT_STEPS):
    """``run_finetune.main`` lipro on --synthetic n: train one epoch and
    save the head; the probe's launches of one fit_batch; a fresh probe's
    loss on one fixed batch (without dropout) before and after
    ``fit_steps`` steps on it (must fall); its
    latents bit for bit the zero-shot engine's encoder (the token mean,
    the projection, l2norm under inference mode) on the same batch; then
    --infer --load_head with artifacts, its launches per batch."""
    from vit_exp_tpu_torch.cli import run_finetune
    from vit_exp_tpu_torch.data.synthetic import SyntheticInferenceDataset
    from vit_exp_tpu_torch.finetune.lipro import (LiProTrainer,
                                                  weighted_bce_with_logits)

    cfg = run_train_config(folder, "lipro", overrides)
    head = folder / "lipro_head.pt"
    t0 = time.perf_counter()
    tr = run_finetune.main(["lipro", "--config", cfg, "--synthetic", str(n),
                            "--save_path", str(head)], device=device)
    train_s = time.perf_counter() - t0
    check(head.exists() and tr.step == n // LIPRO_BATCH, tr.step)
    model = tr.clip_model
    from vit_exp_tpu_torch.core.config import load_config

    ds = SyntheticInferenceDataset(n, arch=load_config(cfg).arch)
    video = torch.as_tensor(np.stack([ds[i]["image"] for i in
                                      range(LIPRO_BATCH)])).to(device)
    labels = np.stack([ds[i]["onehot"] for i in range(LIPRO_BATCH)])
    _, fit_launches = count_launches(lambda: tr.fit_batch(video, labels))
    with torch.inference_mode():
        ref = model.image_latents_from_tokens(model.encode_image_tokens(video))
    lat = tr.image_latents(video)
    same_latents = torch.equal(lat, ref)
    probe = LiProTrainer(model, total_steps=fit_steps, seed=1)
    target = torch.as_tensor(labels, dtype=torch.float32, device=device)

    def eval_loss():   # the probe's loss on the batch without dropout
        with torch.no_grad():
            return float(weighted_bce_with_logits(probe.head(lat), target,
                                                  probe.pos_weight))

    losses = [eval_loss()]
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(fit_steps):
        probe.fit_batch(video, labels)
    fit_s = time.perf_counter() - t0
    losses.append(eval_loss())
    del tr, probe, model, video
    release(device)
    out_dir = folder / "lipro_infer"
    res, infer_launches = count_launches(lambda: run_finetune.main(
        ["lipro", "--config", cfg, "--synthetic", str(n), "--infer",
         "--load_head", str(head), "--results_folder", str(out_dir)],
        device=device))
    pred = np.load(out_dir / "predicted.npz")["arr_0"]
    batches = -(-n // LIPRO_BATCH)
    want = {k: v * batches for k, v in per_batch.items()} if per_batch else None
    print(f"lipro: {n} synthetic volumes trained in {train_s:.3f} s (one "
          f"epoch, batch {LIPRO_BATCH}, host data included); a fresh probe's "
          f"loss on one batch before and after {fit_steps} steps "
          f"{losses[0]:.5f} → "
          f"{losses[-1]:.5f} ({fit_steps * LIPRO_BATCH / fit_s:.3f} volumes/s "
          f"through the frozen tower and the probe); latents bit for bit the "
          f"engine's encoder: {same_latents}; launches of one fit_batch "
          f"{fit_launches} (expected {per_batch}); --infer "
          f"{res['volumes_per_sec']:.3f} volumes/s, mean AUROC "
          f"{res['mean_auc']:.4f} (printed, not bounded), launches "
          f"{infer_launches} (expected {want})", flush=True)
    check(same_latents, "the probe's latents differ from the engine's")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          losses)
    check(pred.shape == (n, 18) and np.isfinite(pred).all()
          and (out_dir / "aurocs.json").exists(), pred.shape)
    check(per_batch is None or (fit_launches == per_batch
                                and infer_launches == want),
          (fit_launches, infer_launches))
    release(device)
    return dict(train_s=train_s, losses=losses, fit_vps=fit_steps
                * LIPRO_BATCH / fit_s, infer_vps=res["volumes_per_sec"],
                fit_launches=fit_launches, infer_launches=infer_launches)


def vocabfine_phase(device, bert_config, folder: Path, expected,
                    int8_per_batch, overrides=None, arch=ARCH, timed=3,
                    n=VOCABFINE_VOLUMES, score_n=BATCH):
    """One VocabFine step (36 prompts of 512 tokens, one volume) on the
    kernels against plain from one state: loss within LOSS_RTOL (rel_to),
    the global gradient norm within GRAD_NORM_RTOL, every parameter plain
    gives a gradient gets one, the launches of the kernel step; ``timed``
    warm steps and the peak device memory.  Then ``run_finetune.main``
    vocabfine on --synthetic n with --save_path, and
    ``run_zero_shot_cls.main --torch_ckpt`` on the export over score_n
    synthetic volumes (int8, one batch): finite probabilities and the
    int8 serving path's launches."""
    from vit_exp_tpu_torch.cli import run_finetune, run_zero_shot_cls
    from vit_exp_tpu_torch.finetune.vocabfine import VocabFineTrainer
    from vit_exp_tpu_torch.models.factory import build_ctclip
    from vit_exp_tpu_torch.train.optimizer import global_norm

    ns = types.SimpleNamespace(**arch)
    kern_model = build_ctclip(ns, bert_config, device=device,
                              attn_impl="pallas", seed=0)
    plain_model = build_ctclip(ns, bert_config, device=device,
                               attn_impl="pallas", use_kernels=False, seed=0)
    plain_model.load_state_dict(kern_model.state_dict())
    g = torch.Generator(device=device).manual_seed(31)
    video = torch.rand((1, 1, arch["temporal_size"], arch["image_size"],
                        arch["image_size"]), generator=g, device=device)
    labels = (torch.rand((18,), generator=g, device=device) > 0.5).float()

    def one_step(model):
        vf = VocabFineTrainer(model, random_tokenizer(bert_config.vocab_size,
                                                      32), total_steps=10)
        loss = vf.fit_batch(video, labels)
        grads = {n: p.grad for n, p in model.named_parameters()}
        norm = float(global_norm(list(grads.values())))
        return vf, loss, norm, {n for n, t in grads.items()
                                if bool(t.abs().max() > 0)}

    _, lp, np_, sp = one_step(plain_model)
    del plain_model
    release(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    (vf, lk, nk, sk), launches = count_launches(lambda: one_step(kern_model))
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        vf.fit_batch(video, labels)
        times.append(time.perf_counter() - t0)
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if device.type == "cuda" else float("nan"))
    dloss, dnorm = rel_to(lk, lp), abs(nk - np_) / np_
    missing = sorted(sp - sk)
    print(f"vocabfine step at full width (1 volume, 36 prompts of 512 "
          f"tokens, attn_impl=pallas): loss kernels {lk:.6f}, plain {lp:.6f} "
          f"(|Δ| / max(|plain|, 1) {dloss:.3e}, tolerance {LOSS_RTOL}); grad "
          f"norm kernels {nk:.6f}, plain {np_:.6f} (rel {dnorm:.3e}, "
          f"tolerance {GRAD_NORM_RTOL}); parameters without a kernel-path "
          f"gradient: {missing}; launches {launches} (expected {expected}); "
          f"peak device memory {peak_gb:.3f} GB", flush=True)
    check(math.isfinite(lk) and math.isfinite(lp) and dloss <= LOSS_RTOL,
          (lk, lp))
    check(dnorm <= GRAD_NORM_RTOL, dnorm)
    check(sp and not missing, missing)
    check(expected is None or launches == expected, launches)
    del vf, kern_model, video
    release(device)
    cfg = run_train_config(folder, "vocabfine", overrides)
    pt = folder / "CTClip.vocabfine.pt"
    t0 = time.perf_counter()
    run_finetune.main(["vocabfine", "--config", cfg, "--synthetic", str(n),
                       "--save_path", str(pt)], device=device)
    cli_s = time.perf_counter() - t0
    release(device)
    out_dir = folder / "vocabfine_scored"
    res, score_launches = count_launches(lambda: run_zero_shot_cls.main(
        ["--config", cfg, "--torch_ckpt", "--model_path", str(pt),
         "--synthetic", str(score_n), "--batch_size", str(score_n),
         "--results_folder", str(out_dir)], device=device))
    probs = np.load(out_dir / pt.name / "predicted.npz")["arr_0"]
    print(f"vocabfine: run_finetune on {n} synthetic volumes with the export "
          f"{cli_s:.3f} s ({pt.stat().st_size / 1e9:.3f} GB .pt); "
          f"run_zero_shot_cls --torch_ckpt on it: probabilities "
          f"{probs.shape}, launches {score_launches} (expected "
          f"{int8_per_batch})", flush=True)
    check(probs.shape == (score_n, 18) and np.isfinite(probs).all()
          and ((probs >= 0) & (probs <= 1)).all(), probs)
    check(int8_per_batch is None or score_launches == int8_per_batch,
          score_launches)
    release(device)
    return dict(launches=launches, score_launches=score_launches,
                loss=lk, dloss=dloss, dnorm=dnorm, times=times,
                peak_gb=peak_gb, cli_s=cli_s)


def text_csvs(folder: Path, n=TEXT_REPORTS, seed=33):
    """n generated reports (VolumeName, Findings_EN) and 18 binary label
    columns."""
    import csv

    r = np.random.default_rng(seed)
    reports, labels = folder / "tc_reports.csv", folder / "tc_labels.csv"
    with open(reports, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["VolumeName", "Findings_EN"])
        for i in range(n):
            sents = [" ".join(r.choice(TEXT_WORDS, r.integers(5, 14)))
                     for _ in range(r.integers(4, 12))]
            w.writerow([f"train_{i}_a_1.nii.gz", ". ".join(sents) + "."])
    with open(labels, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["VolumeName"] + [f"L{j}" for j in range(18)])
        for i in range(n):
            w.writerow([f"train_{i}_a_1.nii.gz",
                        *(str(int(x)) for x in r.integers(0, 2, 18))])
    return str(reports), str(labels)


def text_classifier_phase(device, folder: Path, n=TEXT_REPORTS,
                          max_len=TEXT_LEN_CLS):
    """``run_text_classifier.main`` train (one epoch, batch TEXT_BATCH,
    sentence shuffle on) and infer on n generated reports: finite losses,
    the best checkpoint written, the predictions CSV of n rows; reports/s
    of each (host tokenization included)."""
    from vit_exp_tpu_torch.cli import run_text_classifier

    reports, labels = text_csvs(folder, n)
    results = folder / "tc"
    base = ["--reports", reports, "--labels", labels, "--batch_size",
            str(TEXT_BATCH), "--max_len", str(max_len), "--results_folder",
            str(results)]
    t0 = time.perf_counter()
    tr = run_text_classifier.main(["train", "--epochs", "1", "--augment",
                                   "1", *base], device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    n_train = n - max(TEXT_BATCH, int(n * 0.1))
    check(math.isfinite(tr.best_loss) and (results / "best_model.pt").exists()
          and tr.step == -(-n_train // TEXT_BATCH), (tr.best_loss, tr.step))
    del tr
    release(device)
    out = folder / "tc_predictions.csv"
    t0 = time.perf_counter()
    probs = run_text_classifier.main(["infer", "--out", str(out), *base],
                                     device=device)
    infer_s = time.perf_counter() - t0
    rows = out.read_text().splitlines()
    check(probs.shape == (n, 18) and np.isfinite(probs).all()
          and len(rows) == n + 1, (probs.shape, len(rows)))
    print(f"run_text_classifier: train one epoch over {n_train} reports "
          f"(+{n - n_train} held out) in {train_s:.3f} s "
          f"({n_train / train_s:.3f} reports/s), infer {n} reports in "
          f"{infer_s:.3f} s ({n / infer_s:.3f} reports/s), model build and "
          f"host tokenization included", flush=True)
    release(device)
    return dict(train_rps=n_train / train_s, infer_rps=n / infer_s,
                train_s=train_s, infer_s=infer_s, n_train=n_train)


def aux_phase(device, bert_config, folder: Path, train_step, int8_per_batch,
              overrides=None, arch=ARCH, text_n=TEXT_REPORTS,
              text_len=TEXT_LEN_CLS):
    """Phase 11: the SSL steps, run_train on the SSL copy, lipro,
    vocabfine and the text classifier, in that order.  ``train_step`` is
    one train step's launches (None skips the launch checks, as on the
    CPU)."""
    ssl3 = (None if train_step is None
            else {k: 3 * v for k, v in train_step.items()})
    fwd = (None if train_step is None else expected_launches(
        {k: train_step[k] for k in ("K15", "K2x", "K2h", "K2o", "K4")}))
    out = {"ssl": {t: ssl_phase(device, bert_config, t, ssl3, arch=arch,
                                profile=(t == "simsiam"))
                   for t in SSL_TYPES}}
    out["ssl_run"] = ssl_run_train_phase(device, folder, ssl3, overrides)
    out["lipro"] = lipro_phase(device, folder, fwd, overrides)
    out["vocabfine"] = vocabfine_phase(device, bert_config, folder,
                                       train_step, int8_per_batch, overrides,
                                       arch=arch)
    out["text"] = text_classifier_phase(device, folder, text_n, text_len)
    return out


def aux_lines(aux: dict, card: str) -> list:
    lines = []
    for t, r in aux["ssl"].items():
        busy = (f"; one profiled step: wall {r['wall_ms']:.3f} ms, device "
                f"busy {r['busy_ms']:.3f} ms, idle share "
                f"{1 - r['busy_ms'] / r['wall_ms']:.3f}" if "wall_ms" in r
                else "")
        lines.append(
            f"SSL image-report step ({t}, MLM + visual SSL), batch {BATCH}, "
            f"attn_impl=pallas: {1.0 / statistics.median(r['times']):.3f} "
            f"steps/s (median of {len(r['times'])} warm steps, "
            f"{[round(x, 4) for x in r['times']]} s){busy}; peak device "
            f"memory {r['peak_gb']:.3f} GB on {card}")
    v = aux["vocabfine"]
    lines.append(
        f"vocabfine step (1 volume, 36 prompts of 512 tokens, "
        f"attn_impl=pallas): {1.0 / statistics.median(v['times']):.3f} "
        f"steps/s (median of {len(v['times'])} warm steps, "
        f"{[round(x, 4) for x in v['times']]} s); peak device memory "
        f"{v['peak_gb']:.3f} GB on {card}")
    lp = aux["lipro"]
    lines.append(
        f"lipro (batch {LIPRO_BATCH}): {lp['fit_vps']:.3f} volumes/s "
        f"through the frozen tower and the probe on a resident batch, "
        f"--infer {lp['infer_vps']:.3f} volumes/s with synthetic host data "
        f"on {card}")
    tc = aux["text"]
    lines.append(
        f"report classifier (BERT-base fp32, 512 tokens, batch "
        f"{TEXT_BATCH}): train {tc['train_rps']:.3f} reports/s, infer "
        f"{tc['infer_rps']:.3f} reports/s (host tokenization and model "
        f"build included) on {card}")
    return lines


# sequence parallelism: ring attention's per-rank arithmetic at full width
RING_SHARDS = 4
RING_QK_NORM = 4.0   # q and k rows of norm 4 (learned q/k scales of ~4), so
                     # the softmax is not flat and the running max moves
NCCL_STEPS = 6       # run_train steps with and without the multi-host flags
NCCL_RATE_FROM = 3   # their step rates: median step_time_s from this step
NCCL_LOSS_RTOL = 1e-6


def ring_by_rank(q, k, v, nk, nv, ring: int, scale: float,
                 use_kernel: bool) -> torch.Tensor:
    """The ring's arithmetic for each of ``ring`` ranks in one process, as
    ``cosine_attention(ring_group=...)`` runs it on rank r
    (ops/ring_attention.py): rank r's q shard against the kv shards r,
    r − 1, …, r − ring + 1, one K15-with-lse chunk each, merged in that
    order by merge_lse, the result in q's dtype, then the nulls merged once
    (merge_nulls); the ranks' outputs joined along the tokens."""
    from vit_exp_tpu_torch.ops.ring_attention import merge_nulls, ring_chunks

    n = q.shape[2] // ring

    def shard(t, j):
        return t[:, :, j * n:(j + 1) * n]

    outs = []
    for r in range(ring):
        kv = [(shard(k, (r - i) % ring), shard(v, (r - i) % ring))
              for i in range(ring)]
        out, lse = ring_chunks(shard(q, r), kv, scale=scale,
                               use_kernel=use_kernel)
        out, _ = merge_nulls(out.to(q.dtype), lse, shard(q, r), nk, nv,
                             scale)
        outs.append(out.to(v.dtype))
    return torch.cat(outs, dim=2)


def ring_phase(device, card: str, arch=ARCH, batch=BATCH, ring=RING_SHARDS,
               seed=31):
    """Ring attention at full width in one process: q/k/v (batch, heads,
    13,824, 32) bf16 and the 2 null kv, split into ``ring`` shards of 3,456
    tokens.  Forward and backward (a seeded cotangent) through autograd of
    ``ring_by_rank`` on the kernels (K15 with lse per chunk, the backward
    pair with the lse cotangent δ − glse) and on their plain twins, and of
    full-sequence K15 over the nulls concatenated to k/v
    (``flash_attention_online(null_k=...)``) on the kernels and plain.
    Checks the launches of the ring's kernel run (ring² K15 chunks, ring²
    backward pairs) and holds its output and its five gradients (dq, dk,
    dv, dnull_k, dnull_v) within relative L2 REL_L2_TOL of the full K15
    run and of the plain ring; times both runs; then the chunk kernels'
    rows at the chunk's shapes (K15 with lse, the pair with a nonzero lse
    cotangent) against their plain twins, with SDPA on the chunk as the
    yardstick."""
    from vit_exp_tpu_torch.ops import flash_attention as fa
    from vit_exp_tpu_torch.ops.attention import l2norm

    t_start = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(seed)
    bf = torch.bfloat16
    h, dh = arch["heads"], arch["dim_head"]
    n = (arch["temporal_size"] // arch["temporal_patch_size"]
         * (arch["image_size"] // arch["patch_size"]) ** 2)
    chunk = n // ring
    check(n % ring == 0, (n, ring))

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    q = (l2norm(randn(batch, h, n, dh)) * RING_QK_NORM).to(bf)
    k = (l2norm(randn(batch, h, n, dh)) * RING_QK_NORM).to(bf)
    v = randn(batch, h, n, dh).to(bf)
    nk = (l2norm(randn(h, 2, dh)) * RING_QK_NORM).to(bf)
    nv = randn(h, 2, dh).to(bf)
    dout = randn(batch, h, n, dh).to(bf)
    scale = 1.0 / math.sqrt(dh)

    def ring_fn(use_kernel):
        return lambda *t: ring_by_rank(*t, ring, scale, use_kernel)

    def full_fn(use_kernel):
        return lambda q, k, v, nk, nv: fa.flash_attention_online(
            q, k, v, scale=scale, null_k=nk, null_v=nv,
            use_kernel=use_kernel)

    def fwd_bwd(fn):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (q, k, v, nk, nv)]
        out = fn(*leaves)
        out.backward(dout)
        return [out.detach()] + [t.grad for t in leaves]

    ring_k, counts = count_launches(lambda: fwd_bwd(ring_fn(True)))
    torch.cuda.synchronize()
    expected = expected_launches({"K15": ring * ring, "dKdV": ring * ring,
                                  "dQ": ring * ring})
    print(f"ring attention, {ring} shards of {chunk} tokens: launches of "
          f"one forward and backward {counts} (expected {expected})",
          flush=True)
    check(counts == expected, counts)
    refs = {"full K15": fwd_bwd(full_fn(True)),
            "plain ring": fwd_bwd(ring_fn(False)),
            "plain full": fwd_bwd(full_fn(False))}
    names = ("out", "dq", "dk", "dv", "dnull_k", "dnull_v")
    errors = {}
    for ref_name, ref in refs.items():
        errs = [compare(a, b) for a, b in zip(ring_k, ref)]
        errors[ref_name] = [e[0] for e in errs]
        print(f"ring on the kernels against {ref_name}: relative L2 "
              f"{dict(zip(names, (f'{e[0]:.3e}' for e in errs)))}, max abs "
              f"{dict(zip(names, (f'{e[1]:.3e}' for e in errs)))} (bound "
              f"{REL_L2_TOL} each)", flush=True)
        check(all(torch.isfinite(a.float()).all().item() for a in ring_k)
              and all(e[0] <= REL_L2_TOL for e in errs), (ref_name, errs))
    full_errs = [compare(a, b)[0] for a, b in zip(refs["full K15"],
                                                    refs["plain full"])]
    print(f"full-sequence K15 against plain, for scale: relative L2 "
          f"{dict(zip(names, (f'{e:.3e}' for e in full_errs)))}", flush=True)
    del refs, ring_k
    torch.cuda.empty_cache()
    ring_ms = cuda_ms(lambda: fwd_bwd(ring_fn(True)), 3)
    full_ms = cuda_ms(lambda: fwd_bwd(full_fn(True)), 3)
    print(f"ring attention forward and backward, {ring} shards of {chunk} "
          f"tokens in one process: {ring_ms:.3f} ms against full-sequence "
          f"K15 and its pair {full_ms:.3f} ms on {card}", flush=True)

    # the chunk kernels at the ring's shapes, rank 0's first chunk
    qc, kc, vc, dc = (t[:, :, :chunk] for t in (q, k, v, dout))
    out_c, lse_c = fa.attention_online_plain(qc, kc, vc, scale, save_lse=True)
    glse = randn(batch, h, chunk) * 1e-2
    delta = (dc.float() * out_c.float()).sum(-1) - glse
    bwd = (qc, kc, vc, dc, lse_c, delta, scale)
    del out_c
    src = "vit_exp_tpu_torch/csrc/flash_fwd.cu"
    flash_bwd = "vit_exp_tpu_torch/csrc/flash_bwd.cu"
    tag = f"ring chunk, {chunk} queries × {chunk} keys"
    sdpa_bwd = sdpa_backward_timer(qc, kc, vc, None, None, dc, scale)
    bwd_bytes = nbytes(qc, kc, vc, dc, lse_c, delta)
    cases = [
        Case(f"K15 online-softmax attention + lse ({tag})", "cuda", src,
             "vit_exp_tpu/ops/flash_attention.py:148",
             lambda: fa.attention_online(qc, kc, vc, scale, save_lse=True),
             lambda: fa.attention_online_plain(qc, kc, vc, scale,
                                               save_lse=True), "K15",
             attention_ops(qc, chunk), nbytes(qc, kc, vc),
             sdpa_forward_timer(qc, kc, vc, None, None, scale)),
        Case(f"K7 attention backward, dK/dV kernel, lse cotangent ({tag})",
             "cuda", flash_bwd, "vit_exp_tpu/ops/flash_attention.py:758",
             lambda: fa.attention_bwd_dkv(*bwd),
             lambda: fa.attention_bwd_plain(*bwd)[1:], "dKdV",
             attention_ops(qc, chunk, products=4), bwd_bytes, sdpa_bwd),
        Case(f"K6 attention backward, dQ kernel, lse cotangent ({tag})",
             "cuda", flash_bwd, "vit_exp_tpu/ops/flash_attention.py:725",
             lambda: fa.attention_bwd_dq(*bwd),
             lambda: fa.attention_bwd_plain(*bwd)[0], "dQ",
             attention_ops(qc, chunk, products=3), bwd_bytes, sdpa_bwd),
    ]
    rows = compare_kernels(cases)
    seconds = time.perf_counter() - t_start
    print(f"phase ring: {seconds:.1f} s", flush=True)
    return dict(rows=path_rows(rows, f"ring attention, {ring} shards of "
                                     f"{chunk} tokens", counts),
                ring_ms=ring_ms, full_ms=full_ms, errors=errors,
                seconds=seconds)


# tensor parallelism: one full-width block as the model group's ranks run
# it, in one process
TP_SPLITS = (2, 4)
TP_REL_TOL = 2e-2   # the sliced block against the whole one, relative L2
TP_SEED = 35


def tp_slices(block, parts: int):
    """``parts`` copies of a TransformerBlock, copy m cut to rank m's heads
    and units as parallel/sharding.py cuts them for tensor parallelism,
    with no group (``tp_by_rank`` takes the sums over ranks); returns (the
    copies, the cuts by parameter name)."""
    import copy

    from vit_exp_tpu_torch.parallel.sharding import cut_to_rank

    slices = [copy.deepcopy(block) for _ in range(parts)]
    specs = [cut_to_rank(s, m, parts) for m, s in enumerate(slices)]
    return slices, specs[0]


def tp_by_rank(slices, specs, x, dout):
    """A tensor-parallel block's arithmetic for each rank in one process, as
    ``TransformerBlock`` runs it under ``tp_group`` (models/ctvit3d.py,
    models/layers.py): each rank's attention over its heads to the
    out-projection's fp32 partial sum, the ranks' sum in fp32 rounded once,
    the residual; each rank's K2 over its units (bf16 partials), their sum
    in fp32 rounded once, the residual; backward for the cotangent
    ``dout`` (the input's cotangent sums the ranks', as copy_to_group's
    backward does).  Returns the output, dx and every parameter's gradient
    of the whole block (cut ones joined, whole ones summed over ranks)."""
    from vit_exp_tpu_torch.parallel.sharding import tp_join

    def same(t):
        return t

    x = x.detach().clone().requires_grad_()
    a = torch.stack([s._modules["1"].partial(x, same) for s in slices])
    x1 = x + a.sum(0).to(x.dtype)
    f = torch.stack([s._modules["3"].partial(x1, same).float()
                     for s in slices])
    out = x1 + f.sum(0).to(x.dtype)
    out.backward(dout)
    grads = {}
    for name, _ in slices[0].named_parameters():
        parts = [dict(s.named_parameters())[name].grad for s in slices]
        grads[name] = (tp_join(parts, specs[name]) if name in specs
                       else torch.stack([p.float() for p in parts]).sum(0))
    return out.detach(), x.grad, grads


def tp_kernel_cases(device, parts: int, seed=TP_SEED):
    """The kernels of one rank's block slice at full width, 13,824 tokens:
    K15 with lse and the backward pair over 8/parts heads and the 13,826
    concatenated keys, K2's three stages and K8's six at 2I = 4,096/parts;
    each against its plain twin."""
    from vit_exp_tpu_torch.ops import geglu_ff

    g = torch.Generator(device=device).manual_seed(seed)
    bf = torch.bfloat16
    tag = f" (tensor-parallel slice, model {parts})"
    d = ARCH["dim"]
    inner = int(4.0 * 2 / 3 * d) // parts
    m = (ARCH["temporal_size"] // ARCH["temporal_patch_size"]
         * (ARCH["image_size"] // ARCH["patch_size"]) ** 2)
    cases = [c for c in online_kernel_cases(
        device, {**ARCH, "heads": ARCH["heads"] // parts}, batch=1,
        seed=seed) if c.name != "K15 online-softmax attention"]

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=device) * std).to(bf)

    x = randn(m, d)
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    w1p = randn(d, 2 * inner, std=d ** -0.5)
    w2 = randn(inner, d, std=inner ** -0.5)
    d1 = randn(2 * inner, std=0.1).float()
    xn = geglu_ff.geglu_ff_x(x, mu, inv)
    act = geglu_ff.geglu_ff_h(xn, w1p, d1)
    ff, k2_src = "vit_exp_tpu_torch/csrc/geglu_ff.cu", \
        "vit_exp_tpu/ops/geglu_ff.py:63"
    cases += [
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
    ] + k8_cases(device, d, inner, m, g)
    for case in cases:
        case.name += tag
    return cases


def tp_phase(device, card: str, splits=TP_SPLITS, seed=TP_SEED):
    """Tensor parallelism at full width in one process: one tower block
    (dim 768, 8 heads × 32, I 2,048, attn_impl="pallas", bf16) on one
    volume's 13,824 tokens, forward and backward for a seeded cotangent,
    whole and as ``parts`` ranks' slices (``tp_by_rank``) for each of
    ``splits``: the slices on the kernels held to the whole block on the
    kernels (output, dx and every parameter's gradient within TP_REL_TOL
    relative L2), their launches counted (each of K15, the pair, K2 and K8
    once a rank), both timed; then the slices' kernel rows against their
    plain twins."""
    from vit_exp_tpu_torch.models.ctvit3d import TransformerBlock
    from vit_exp_tpu_torch.models.factory import init_parameters_

    t_start = time.perf_counter()
    n = (ARCH["temporal_size"] // ARCH["temporal_patch_size"]
         * (ARCH["image_size"] // ARCH["patch_size"]) ** 2)
    block = TransformerBlock(ARCH["dim"], ARCH["heads"], ARCH["dim_head"],
                             None, attn_impl="pallas", device=device)
    init_parameters_(block, seed)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():   # norms and scales away from their init
        for name, p in block.named_parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g,
                                         device=device))
    bf = torch.bfloat16
    x = torch.randn(1, n, ARCH["dim"], generator=g, device=device).to(bf)
    dout = torch.randn(1, n, ARCH["dim"], generator=g, device=device,
                       ).to(bf) * 1e-2

    def whole():
        xx = x.detach().clone().requires_grad_()
        block.zero_grad(set_to_none=True)
        out = block(xx)
        out.backward(dout)
        return out.detach(), xx.grad, {k: p.grad for k, p in
                                       block.named_parameters()}

    ref = whole()
    whole_ms = cuda_ms(whole, 3)
    out = dict(rows=[], errors={}, ms={}, whole_ms=whole_ms)
    for parts in splits:
        slices, specs = tp_slices(block, parts)

        def run():
            for s in slices:
                s.zero_grad(set_to_none=True)
            return tp_by_rank(slices, specs, x, dout)

        got, counts = count_launches(run)
        torch.cuda.synchronize()
        k8 = {"K8y": parts, "K8dh": parts, "K8dy": parts, "K8dx": parts,
              "K8w": 2 * parts, "K8sum": 4 * parts}
        expected = expected_launches({"K15": parts, "dKdV": parts,
                                      "dQ": parts, "K2x": parts,
                                      "K2h": parts, "K2o": parts, **k8})
        print(f"tensor-parallel block, model {parts}: launches of one "
              f"forward and backward {counts} (expected {expected})",
              flush=True)
        check(counts == expected, (parts, counts))
        errs = {"out": compare(got[0], ref[0])[0],
                "dx": compare(got[1], ref[1])[0],
                **{f"d[{k}]": compare(got[2][k], v)[0]
                   for k, v in ref[2].items()}}
        worst = max(errs, key=errs.get)
        print(f"tensor-parallel block, model {parts}, against the whole "
              f"block on the kernels: relative L2 out {errs['out']:.3e}, dx "
              f"{errs['dx']:.3e}, parameter gradients "
              f"{ {k: f'{v:.2e}' for k, v in errs.items() if k[0] == 'd' and k != 'dx'} }"
              f"; worst {worst} {errs[worst]:.3e} (bound {TP_REL_TOL})",
              flush=True)
        check(all(math.isfinite(e) and e <= TP_REL_TOL
                  for e in errs.values()), (parts, errs))
        out["errors"][parts] = errs
        out["ms"][parts] = cuda_ms(run, 3)
        print(f"tensor-parallel block, model {parts}, forward and backward "
              f"of its {parts} slices in one process {out['ms'][parts]:.3f} "
              f"ms against the whole block {whole_ms:.3f} ms on {card}",
              flush=True)
        del got, slices
        torch.cuda.empty_cache()
        rows = compare_kernels(tp_kernel_cases(device, parts))
        out["rows"] += path_rows(rows, f"tensor-parallel block, model "
                                       f"{parts}, one rank's slice", {
            k: v // parts for k, v in counts.items()})
    out["seconds"] = time.perf_counter() - t_start
    print(f"phase tp_by_rank: {out['seconds']:.1f} s", flush=True)
    return out


def serve_mesh_phase(device, card: str, n=4, lone=2):
    """``serve --mesh 1,1,1`` on the card against the flagless server, both
    at their int8 default on the same seeded random weights
    (RUN_TRAIN_CONFIG's full-width arch): predict_batch of ``n`` volumes,
    then ``lone`` of them as lone /classify requests to each server, every
    answer bit for bit."""
    import base64
    import io
    import threading
    import urllib.request

    from vit_exp_tpu_torch.cli import serve

    t_start = time.perf_counter()
    services = {}
    for name, extra in (("flagless", []), ("mesh", ["--mesh", "1,1,1"])):
        args = serve.parse_args(["--config", str(RUN_TRAIN_CONFIG), *extra])
        services[name] = serve.build_service(args, device)
    engine, _, shape, ch = services["flagless"]
    g = torch.Generator().manual_seed(37)
    vols = torch.rand((n, ch, *shape), generator=g).numpy()
    probs = {k: s[0].predict_batch(vols) for k, s in services.items()}
    check(np.array_equal(probs["mesh"], probs["flagless"]),
          "serve --mesh 1,1,1 predict_batch")
    answers = {}
    for name, (eng, latent_fn, shp, chn) in services.items():
        srv = serve.build_server(eng, latent_fn, shp, 0, max_batch=1,
                                 channels=chn)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{srv.server_address[1]}/classify"
            got = []
            for v in vols[:lone]:
                buf = io.BytesIO()
                np.save(buf, v)
                body = json.dumps({"volume": base64.b64encode(
                    buf.getvalue()).decode()}).encode()
                req = urllib.request.Request(url, body, {
                    "Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as resp:
                    got.append(json.loads(resp.read())["probs"])
            answers[name] = got
        finally:
            srv.shutdown()
            srv.server_close()
            srv.batcher.close()
    check(answers["mesh"] == answers["flagless"],
          "serve --mesh 1,1,1 answers")
    seconds = time.perf_counter() - t_start
    print(f"serve --mesh 1,1,1 on the card: predict_batch of {n} volumes "
          f"and {lone} lone /classify requests bit for bit the flagless "
          f"server's (int8); phase serve_mesh: {seconds:.1f} s on {card}",
          flush=True)
    del services, engine
    return dict(seconds=seconds)


# the legacy generative stack at GenerateCT's published shapes (phase
# "generative"): the CTViT of dim 512, codebook 8,192, 128², patch 16,
# temporal patch 2, depth 4 + 4, 8 heads × 32 on a (1, 1, 201, 128, 128)
# volume (101 × 8 × 8 = 6,464 tokens), MaskGit of dim 512, depth 6, 8 heads
# × 64 over those tokens, cross-attending to BERT-base's 768-wide states
GEN_CTVIT = dict(dim=512, codebook_size=8192, image_size=128, patch_size=16,
                 temporal_patch_size=2, spatial_depth=4, temporal_depth=4,
                 dim_head=32, heads=8)
GEN_MASKGIT = dict(dim=512, depth=6, heads=8, dim_head=64)
GEN_FRAMES = 201
GEN_STEPS = 9           # discriminator steps at 2, 5, 8; the penalty at 8
GEN_CHECK_FRAMES = 17   # the fp32 card-against-CPU encode and decode
GEN_CPU_RTOL = 1e-4     # relative L2 there, fp32 on both sides, TF32 off
GEN_TEXT_LEN = 32       # prompt tokens, the last 8 padding
GEN_SAMPLE_STEPS = 18
GEN_COND_SCALE = 5.0


def _peak_gb(device) -> float:
    return (torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda"
            else float("nan"))


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def generative_phase(device, card: str, bert_config, ctvit_kw=GEN_CTVIT,
                     maskgit_kw=GEN_MASKGIT, frames=GEN_FRAMES,
                     steps=GEN_STEPS, check_frames=GEN_CHECK_FRAMES,
                     sample_steps=GEN_SAMPLE_STEPS, text_len=GEN_TEXT_LEN,
                     recon_argv=()):
    """The legacy generative stack (plain torch: no kernel): CTViTTrainer
    for ``steps`` steps on one seeded volume, each loss term and λ finite
    and the discriminator steps where the schedule puts them; the fp32
    encode → quantize → decode of the first ``check_frames`` frames on the
    device against the CPU (the encoded tokens, and the decode of the CPU's
    indices, within GEN_CPU_RTOL; the indices that agree printed); one
    MaskGITTrainer.fit_batch and one MaskGITTransformer.sample on BERT's
    states for a padded prompt (ids in range, no mask id, the decoded volume
    finite at the input's shape); run_ctvit_recon.main on one synthetic
    volume."""
    from vit_exp_tpu_torch.cli import run_ctvit_recon
    from vit_exp_tpu_torch.core.precision import FP32_POLICY
    from vit_exp_tpu_torch.data.nifti import read_nifti
    from vit_exp_tpu_torch.models.bert import BertModel
    from vit_exp_tpu_torch.models.ctvit import CTViT
    from vit_exp_tpu_torch.models.factory import init_parameters_
    from vit_exp_tpu_torch.models.maskgit import MaskGit
    from vit_exp_tpu_torch.models.maskgit_pipeline import MaskGITTransformer
    from vit_exp_tpu_torch.train.ctvit_trainer import (CTViTTrainer,
                                                       MaskGITTrainer)

    t_start = time.perf_counter()
    out = {}
    folder = Path(tempfile.mkdtemp(prefix="chip_smoke_gen_"))
    try:
        model = CTViT(**ctvit_kw, device=device)
        init_parameters_(model, 0)
        trainer = CTViTTrainer(model, results_folder=str(folder / "vqgan"),
                               sample_every=0, seed=0)
        size = ctvit_kw["image_size"]
        g = torch.Generator(device=device).manual_seed(41)
        video = torch.rand((1, 1, frames, size, size), generator=g,
                           device=device) * 2 - 1
        _reset_peak(device)
        logs, times = [], []
        for _ in range(steps):
            lg, seconds = timed(lambda: trainer.train_step(video), device)
            logs.append(lg)
            times.append(seconds)
        check(all(math.isfinite(v) for lg in logs for v in lg.values()),
              ("CTViTTrainer losses", logs))
        check([i for i, lg in enumerate(logs) if "discr_loss" in lg]
              == [i for i in range(steps) if (i + 1) % 3 == 0], logs)
        out.update(logs=logs, times=times, peak_gb=_peak_gb(device),
                   sps=1.0 / statistics.median(times[1:] or times))

        # fp32 on both sides from the trained weights (TF32 is off)
        sd = trainer.ema_model().state_dict()
        card32, cpu32 = (CTViT(**ctvit_kw, policy=FP32_POLICY, device=dev)
                         for dev in (device, torch.device("cpu")))
        card32.load_state_dict(sd)
        cpu32.load_state_dict(sd)
        clip = video[:, :, :check_frames]
        with torch.no_grad():
            enc_card, enc_cpu = card32(clip), cpu32(clip.cpu())
            idx_card = card32.quantize(enc_card)[1].cpu()
            idx_cpu = cpu32.quantize(enc_cpu)[1]
            dec_card = card32.decode_from_indices(idx_cpu.to(device))
            dec_cpu = cpu32.decode_from_indices(idx_cpu)
        out.update(enc_rel=rel_l2(enc_card.cpu(), enc_cpu),
                   dec_rel=rel_l2(dec_card.cpu(), dec_cpu),
                   agree=int((idx_card == idx_cpu).sum()),
                   n_idx=idx_cpu.numel())
        check(out["enc_rel"] <= GEN_CPU_RTOL and out["dec_rel"] <= GEN_CPU_RTOL,
              ("card against CPU", out["enc_rel"], out["dec_rel"]))
        del card32, cpu32, enc_card, dec_card
        release(device)

        # MaskGIT over the trained CTViT, conditioned on BERT's states
        bert = BertModel(bert_config, device=device).eval()
        init_parameters_(bert, 0)
        tok = random_tokenizer(bert_config.vocab_size, 43)([""], text_len)
        ids = torch.as_tensor(tok["input_ids"], device=device)
        mask = torch.ones_like(ids)
        mask[:, -8:] = 0

        def text_encode(i, m):
            return bert(i, m)

        grid = (1 + (frames - 1) // ctvit_kw["temporal_patch_size"],
                size // ctvit_kw["patch_size"], size // ctvit_kw["patch_size"])
        seq = grid[0] * grid[1] * grid[2]
        mg = MaskGit(ctvit_kw["codebook_size"], seq, **maskgit_kw,
                     dim_context=bert_config.hidden_size, device=device)
        init_parameters_(mg, 1)
        ctvit = trainer.ema_model()
        pipe = MaskGITTransformer(ctvit, mg, text_encode)
        _reset_peak(device)
        out["mg_loss"], out["fit_s"] = timed(
            lambda: MaskGITTrainer(pipe).fit_batch(video, ids, mask), device)
        out["mg_peak_gb"] = _peak_gb(device)
        check(math.isfinite(out["mg_loss"]), ("MaskGIT loss", out["mg_loss"]))
        mg.eval()
        seen = {}
        decode = ctvit.decode_from_indices

        def record(i):
            seen["ids"] = i
            return decode(i)

        ctvit.decode_from_indices = record
        try:
            vol, out["sample_s"] = timed(lambda: pipe.sample(
                ids, mask, token_grid=grid, steps=sample_steps,
                cond_scale=GEN_COND_SCALE,
                generator=torch.Generator(device=device).manual_seed(44)),
                device)
        finally:
            del ctvit.decode_from_indices
        sampled = seen["ids"]
        check(sampled.shape == (1, *grid) and int(sampled.min()) >= 0
              and int(sampled.max()) < mg.mask_id, ("sampled ids", sampled))
        check(vol.shape == video.shape and bool(torch.isfinite(vol).all()),
              ("sampled volume", tuple(vol.shape)))
        out["distinct_ids"] = int(sampled.unique().numel())
        del bert, mg, pipe, vol, trainer, model
        release(device)

        written = run_ctvit_recon.main(
            ["--synthetic", "1", "--results_folder", str(folder / "recon"),
             *recon_argv], device=str(device))
        recon = read_nifti(written[0])
        check(len(written) == 1 and np.isfinite(recon).all(),
              ("run_ctvit_recon", written))
        out["recon_shape"] = recon.shape
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    release(device)
    out["seconds"] = time.perf_counter() - t_start
    return out


def generative_lines(r: dict, card: str) -> list:
    lines = []
    for i, lg in enumerate(r["logs"]):
        lines.append(f"CTViTTrainer step {i}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in lg.items()))
    lines.append(
        f"CTViTTrainer at GenerateCT's width on (1, 1, {GEN_FRAMES}, 128, "
        f"128): {r['sps']:.3f} steps/s (median of steps 1-{len(r['times']) - 1}"
        f", {[round(t, 4) for t in r['times']]} s), peak device memory "
        f"{r['peak_gb']:.3f} GB on {card}")
    lines.append(
        f"CTViT fp32 at {GEN_CHECK_FRAMES} frames, card against CPU: encoded "
        f"tokens relative L2 {r['enc_rel']:.3e}, decode of the CPU's indices "
        f"{r['dec_rel']:.3e} (tolerance {GEN_CPU_RTOL}); VQ indices agreeing "
        f"{r['agree']}/{r['n_idx']}")
    lines.append(
        f"MaskGIT (dim 512, depth 6, 8 heads × 64, 6,464 tokens, BERT-base "
        f"states): fit_batch loss {r['mg_loss']:.5f} in {r['fit_s']:.3f} s "
        f"(peak device memory {r['mg_peak_gb']:.3f} GB); sample of "
        f"{GEN_SAMPLE_STEPS} steps at cond_scale {GEN_COND_SCALE} and the "
        f"decode {r['sample_s']:.3f} s, {r['distinct_ids']} distinct ids; "
        f"run_ctvit_recon --synthetic 1 wrote {r['recon_shape']}; phase "
        f"generative: {r['seconds']:.1f} s on {card}")
    return lines


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def nccl_phase(device, folder: Path, expected: dict, card: str,
               steps=NCCL_STEPS):
    """``run_train.main`` at full width (batch 4, attn_impl="pallas", 8
    synthetic samples) for ``steps`` steps, first as before, then through
    the multi-host flags (--coordinator_address localhost:<free port>
    --num_processes 1 --process_id 0): an NCCL group of one rank, in which
    the trainer's gathers, gradient all-reduce, metric all-reduce and
    preemption all-reduce are copies.  Checks the group's backend and
    device, that it is left at the end, the launches of the last step of
    each run, and every logged loss of the two runs within NCCL_LOSS_RTOL
    relative; returns the step rates (the median step_time_s from step
    NCCL_RATE_FROM on, past the warm-up and the loader's first fill) and
    the flagged run's launches."""
    import torch.distributed as dist

    from vit_exp_tpu_torch.cli import run_train

    t_start = time.perf_counter()
    seen = []
    inner = run_train.make_trainer

    def make_trainer(args, dev):
        seen.append((dist.get_backend() if dist.is_initialized() else None,
                     str(dev)))
        return inner(args, dev)

    runs = {}
    run_train.make_trainer = make_trainer
    try:
        for name, flags in (("flagless", []), ("nccl", [
                "--coordinator_address", f"localhost:{free_port()}",
                "--num_processes", "1", "--process_id", "0"])):
            cfg = run_train_config(folder, name)
            with watch_steps(steps) as (_, launches):
                tr = run_train.main(["--config", cfg, "--synthetic", "8",
                                     "--debug", "--steps", str(steps),
                                     *flags], device=device)
            lines = read_metrics(folder / name)
            check(tr.status == "completed" and tr.step == steps
                  and [d["step"] for d in lines] == list(range(1, steps + 1)),
                  (name, tr.status, lines))
            check(launches == expected, (name, launches))
            runs[name] = dict(
                losses=[[d[k] for k in ("ds0_cl_loss", "ds0_loss")]
                        for d in lines],
                times=[d["step_time_s"] for d in lines], launches=launches)
            tr.close()
            del tr
            release(device)
    finally:
        run_train.make_trainer = inner
    check(seen == [(None, "cuda"), ("nccl", "cuda:0")]
          and not dist.is_initialized(), seen)
    a, b = (np.asarray(runs[k]["losses"], np.float64)
            for k in ("nccl", "flagless"))
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    print(f"run_train through the multi-host flags (NCCL, one rank) against "
          f"the run without them: losses {runs['nccl']['losses']} against "
          f"{runs['flagless']['losses']}, largest relative difference "
          f"{rel:.3e} (bound {NCCL_LOSS_RTOL})", flush=True)
    check(all(math.isfinite(x) for x in a.ravel()) and rel <= NCCL_LOSS_RTOL,
          rel)
    sps = {k: 1.0 / statistics.median(r["times"][NCCL_RATE_FROM - 1:])
           for k, r in runs.items()}
    seconds = time.perf_counter() - t_start
    print(f"run_train, batch {BATCH}, {steps} steps on 8 synthetic samples: "
          f"{sps['flagless']:.3f} steps/s without the flags, "
          f"{sps['nccl']:.3f} steps/s through them (NCCL group of one "
          f"rank; median step_time_s of steps {NCCL_RATE_FROM}-{steps}: "
          f"{[round(t, 4) for t in runs['flagless']['times']]} s and "
          f"{[round(t, 4) for t in runs['nccl']['times']]} s) on {card}; "
          f"phase nccl: {seconds:.1f} s", flush=True)
    return dict(sps=sps, rel=rel, launches=runs["nccl"]["launches"],
                seconds=seconds)


# phase "widths": the two tiny --synthetic configs the JAX package ships
# (dim 48, head dim 8 on 4 heads, 2I 256, patch 8 over 32 px: 64 tokens a
# volume) through the kernels, and the kernel rows of their widths and of
# the attention kernels' other head-dim instances
TINY_CONFIGS = (ROOT / "configs" / "ct_clip_debug_synthetic.yaml",
                ROOT / "configs" / "ct_clip_dcl_synthetic.yaml")
TINY_SYNTHETIC, TINY_STEPS = 16, 3     # run_train --synthetic 16 --steps 3
TINY_SERVE_VOLUMES = 4                 # run_zero_shot_cls: one batch of 4
TINY_TEXT_LEN = 512
# the tiny widths' kernel rows: the tiny arch at 864 frames, batch 4 (13,824
# tokens: D 48, 2I 256; K3 and K12/K13 at K 48, F 96; K14 at K 32, F 48;
# the patch embedding at patch 8 over 32 px, CPT 4)
TINY_ROW_ARCH = dict(dim=48, image_size=32, patch_size=8, temporal_size=864,
                     temporal_patch_size=4, transformer_blocks=2, dim_head=8,
                     heads=4, channels=1, use_flash_attention=True)
# the attention kernels' instances other than 32, at the production shape
# (8 heads, 13,824 tokens, batch 4)
HEAD_DIM_ROWS = (16, 64)


def head_dim_cases(device, d: int, batch=BATCH, seed=40):
    """K1 (strided q/k/v as the model hands them over, 2 nulls), K15 with
    and without lse and the backward pair over the concatenated kv, and the
    int8 attention, at head dim d and the production shape."""
    from vit_exp_tpu_torch.ops import flash_attention as fa
    from vit_exp_tpu_torch.ops.attention import l2norm, logit_bound

    arch = dict(ARCH, dim_head=d)
    g = torch.Generator(device=device).manual_seed(seed)
    bf = torch.bfloat16
    h = arch["heads"]
    n = (arch["temporal_size"] // arch["temporal_patch_size"]
         * (arch["image_size"] // arch["patch_size"]) ** 2)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    def heads(t):   # (b, n, h·d) → strided (b, h, n, d) view
        return t.reshape(batch, n, h, d).transpose(1, 2)

    q = l2norm(heads(randn(batch, n, h * d).to(bf)))
    kvp = randn(batch, n, 2 * h * d).to(bf)
    k = l2norm(heads(kvp[..., :h * d]))
    v = heads(kvp[..., h * d:])
    nk, nv = l2norm(randn(h, 2, d).to(bf)), randn(h, 2, d).to(bf)
    scale = 1.0 / math.sqrt(d)
    k1 = (q, k, v, nk, nv, torch.tensor(scale, device=device), scale)
    same_bits_twice(lambda: (fa.attention_static(*k1),),
                    f"K1 at head dim {d} over {n} keys and 2 nulls: out")
    q_scale, k_scale = 1 + 0.1 * randn(d), 1 + 0.1 * randn(d)
    q8, k8, qe, qn = fa.quantize_qk(q * q_scale.to(bf), k * k_scale.to(bf),
                                    scale)
    attn = (q8, k8, v, qe, qn, nk.float() * k_scale, nv,
            logit_bound(q_scale, k_scale, scale))
    same_bits_twice(lambda: (fa.attention_static_int8(*attn),),
                    f"the int8 attention at head dim {d}: out")
    cases = [
        Case("K1 static-max attention", "cuda",
             "vit_exp_tpu_torch/csrc/flash_fwd.cu",
             "vit_exp_tpu/ops/flash_attention.py:78",
             lambda: fa.attention_static(*k1),
             lambda: fa.attention_static_plain(*k1), "K1",
             attention_ops(q, n, 2), nbytes(q, k, v, nk, nv),
             sdpa_forward_timer(q, k, v, nk, nv, scale)),
        *online_kernel_cases(device, arch, batch, seed + 1),
        Case("K9/K10 int8 static-max attention", "cuda",
             "vit_exp_tpu_torch/csrc/flash_static_int8.cu",
             "vit_exp_tpu/ops/flash_attention.py:506",
             lambda: fa.attention_static_int8(*attn),
             lambda: fa.attention_static_int8_plain(*attn), "K9/K10",
             {"int8": attention_ops(q8, n, 2, products=1)["bf16"],
              **attention_ops(q8, n, 2, products=1)}, nbytes(*attn))]
    for case in cases:
        case.name += f" (head dim {d})"
    return cases


TINY_TAG = " (D 48, the tiny widths, 13,824 tokens)"


def widths_phase(device, folder: Path, configs=TINY_CONFIGS,
                 text_len=TINY_TEXT_LEN, synthetic=TINY_SYNTHETIC,
                 steps=TINY_STEPS, volumes=TINY_SERVE_VOLUMES) -> dict:
    """Each tiny config on the card through the kernels: no refusal from
    ``kernel_refusals`` (plain, fused, fused int8) or
    ``patch_embed_refusal``; one contrastive step on the kernels against
    one on plain from one state (attn_impl="pallas", the config's batch
    and loss: loss within LOSS_RTOL of the plain loss, relative to it,
    grad norm within GRAD_NORM_RTOL, every
    parameter plain gives a gradient gets one, the step's launches);
    ``run_train.main --synthetic 16 --steps 3`` (finite losses, step 3's
    launches: K15, the pair, K2, K8, the patch embedding); then
    ``run_zero_shot_cls.main --synthetic 4`` at its int8 default and with
    --no-int8, each launch counted over the call (one batch: the whole
    serving set of its mode) and its probabilities within PROB_TOL of the
    all-plain engine on the same weights and batch.  Returns per config
    the numbers and the launch counts of each run.  On the CPU (a
    rehearsal) every path is the plain one: no launch is expected and the
    patch embedding's refusal, which asks the kernel library, is not
    asked."""
    from vit_exp_tpu_torch.cli import run_train, run_zero_shot_cls
    from vit_exp_tpu_torch.core.config import load_config
    from vit_exp_tpu_torch.data.synthetic import SyntheticInferenceDataset
    from vit_exp_tpu_torch.data.tokenizer import load_tokenizer
    from vit_exp_tpu_torch.eval.zero_shot import ZeroShotClassifier
    from vit_exp_tpu_torch.models.factory import (bert_config_for,
                                                  build_ctclip,
                                                  kernel_refusals,
                                                  patch_embed_refusal)

    def expect(counts):
        return counts if device.type == "cuda" else expected_launches({})

    out = {}
    for path in configs:
        name, t0 = path.stem, time.perf_counter()
        config = load_config(str(path))
        a, blocks = config.arch, config.arch.transformer_blocks
        refusals = [r for fq, i8 in ((False, False), (True, False),
                                     (True, True))
                    for r in kernel_refusals(a, fuse_qkv=fq, int8=i8)]
        if device.type == "cuda":
            refusals += patch_embed_refusal(a)
        check(not refusals, (name, refusals))
        tok = load_tokenizer()
        bert = bert_config_for(config, tok)
        batch = config.train_data_list[0]["batch_size"]
        dcl = bool(getattr(config.ct_clip_arch,
                           "decoupled_contrastive_learning", False))
        res, step_launches, kern, _ = compare_train_steps(
            device, {k: getattr(a, k) for k in ARCH}, bert, batch, text_len,
            attn_impl="pallas", dcl=dcl)
        del kern
        release(device)
        # relative to the loss itself, as the card tests hold it: the
        # decoupled contrastive loss sits near 0 at random weights (the
        # positive pair is left out), where rel_to's absolute floor would
        # be looser than the loss
        loss_rel = abs(res["loss_kernel"] - res["loss_plain"]) / abs(
            res["loss_plain"])
        norm_rel = abs(res["norm_kernel"] - res["norm_plain"]) / res[
            "norm_plain"]
        print(f"widths {name}: one step at batch {batch}, kernels against "
              f"plain from one state: loss {res['loss_kernel']:.6f} vs "
              f"{res['loss_plain']:.6f} (rel {loss_rel:.3e}), grad norm "
              f"{res['norm_kernel']:.6f} vs {res['norm_plain']:.6f} (rel "
              f"{norm_rel:.3e}); tower gradients, backward kernels against "
              f"their twins, max rel L2 "
              f"{max(e for e, _ in res['tower'].values()):.3e} (printed, not "
              f"bounded); launches {step_launches}", flush=True)
        check(res["finite"] and not res["missing"] and loss_rel <= LOSS_RTOL
              and norm_rel <= GRAD_NORM_RTOL
              and step_launches == expect(train_launches(blocks)),
              (name, res))

        cfg = run_train_config(folder, name, source=path)
        with watch_steps(steps) as (_, rt_launches):
            tr = run_train.main(["--config", cfg, "--synthetic",
                                 str(synthetic), "--steps", str(steps),
                                 "--debug"], device=device)
        lines = read_metrics(folder / name)
        losses = [d["ds0_cl_loss"] for d in lines]
        step_s = [d["step_time_s"] for d in lines]
        print(f"widths {name}: run_train --synthetic {synthetic} --steps "
              f"{steps}: losses {[round(x, 5) for x in losses]}, step times "
              f"{[round(x, 4) for x in step_s]} s; step {steps}'s launches "
              f"{rt_launches}", flush=True)
        check(tr.status == "completed" and tr.step == steps
              and len(losses) == steps
              and all(math.isfinite(x) for x in losses), (name, losses))
        check(rt_launches == expect(train_launches(blocks)),
              (name, rt_launches))
        del tr
        release(device)

        serve = {}
        vols = torch.as_tensor(np.stack([
            SyntheticInferenceDataset(volumes, arch=a)[i]["image"]
            for i in range(volumes)]), device=device)
        for int8 in (True, False):
            tag = "int8" if int8 else "bf16"
            argv = ["--config", str(path), "--synthetic", str(volumes),
                    "--results_folder", str(folder / f"{name}_{tag}")]
            t1 = time.perf_counter()
            zs, launches = count_launches(lambda: run_zero_shot_cls.main(
                argv + ([] if int8 else ["--no-int8"]), device=device))
            call_s = time.perf_counter() - t1
            kinds = (("K9/K10", "K11y", "K11h", "K11q", "K11o", "K13x",
                      "K13mm", "K14") if int8
                     else ("K1", "K2x", "K2h", "K2o", "K3"))
            expected = expect(expected_launches(
                {"K4": 1, **{k: blocks for k in kinds}}))
            probs = np.load(folder / f"{name}_{tag}" / "random_init"
                            / "predicted.npz")["arr_0"]
            mode = dict(int8=True) if int8 else dict(
                attn_impl="pallas_static")
            plain = build_ctclip(config, bert, device=device, fuse_qkv=True,
                                 use_kernels=False, **mode)
            ref = ZeroShotClassifier(plain, tok).predict_batch(vols)
            dprob = float(np.abs(probs - ref).max())
            print(f"widths {name}: run_zero_shot_cls {tag} on {volumes} "
                  f"synthetic volumes in {call_s:.3f} s: launches {launches} "
                  f"(expected {expected}); max |prob(kernels) - "
                  f"prob(plain)| {dprob:.3e} (tolerance {PROB_TOL})",
                  flush=True)
            check(zs and launches == expected and probs.shape == ref.shape
                  and np.isfinite(probs).all() and dprob <= PROB_TOL,
                  (name, tag, launches, dprob))
            serve[tag] = dict(launches=launches, dprob=dprob, call_s=call_s)
            del plain
            release(device)
        out[name] = dict(loss_rel=loss_rel, norm_rel=norm_rel,
                         step_launches=step_launches, losses=losses,
                         step_s=step_s, rt_launches=rt_launches, serve=serve,
                         seconds=time.perf_counter() - t0)
    return out


def widths_kernel_rows(rows: dict, widths: dict) -> list:
    """The JSON rows of phase "widths": the tiny widths' rows on each tiny
    config's paths; the head-dim 16 rows on the tiny configs' paths (head
    dim 8 runs the D 16 instance); the head-dim 64 rows on none."""
    out = []
    for name, w in widths.items():
        serve8, serve16 = (w["serve"][t]["launches"] for t in ("int8", "bf16"))
        for phase, path, counts in (
                ("tiny_train", f"widths {name}, run_train step {TINY_STEPS}",
                 w["rt_launches"]),
                ("tiny_serve_bf16", f"widths {name}, run_zero_shot_cls bf16",
                 serve16),
                ("tiny_serve_int8", f"widths {name}, run_zero_shot_cls int8",
                 serve8),
                ("head16", f"widths {name}: its run_train step, bf16 and "
                 f"int8 run_zero_shot_cls (head dim 8 runs the D 16 "
                 f"instance)", {k: w["rt_launches"][k] + serve16[k]
                                + serve8[k] for k in serve8})):
            out += path_rows(rows[phase], path, counts)
    for row in rows["head64"]:
        out.append({**{k: v for k, v in row.items() if k != "counter"},
                    "name": f"{row['name']} [on no path: no config in the "
                            f"repo has head dim 64]",
                    "launches": 0})
    return out


def widths_lines(w: dict, card: str) -> list:
    return [f"widths phase, {name}: one step on the kernels within "
            f"{r['loss_rel']:.3e} (loss) and {r['norm_rel']:.3e} (grad norm) "
            f"of plain; run_train step times "
            f"{[round(x, 4) for x in r['step_s']]} s; run_zero_shot_cls "
            f"int8 {r['serve']['int8']['call_s']:.3f} s, bf16 "
            f"{r['serve']['bf16']['call_s']:.3f} s, probabilities within "
            f"{r['serve']['int8']['dprob']:.3e} and "
            f"{r['serve']['bf16']['dprob']:.3e} of plain; "
            f"{r['seconds']:.1f} s in all, on {card}"
            for name, r in w.items()]


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
    # each head-dim instance of the attention kernels (D 16, 32, 64; the
    # int8 kernel's 32, 64) on its own line
    for entry, regs, st, ld in ptxas_entries(build_log, ATTENTION_KERNELS):
        print(f"ptxas instance {entry}: {regs} registers, spill stores {st} "
              f"bytes, spill loads {ld} bytes", flush=True)
    check(set(ptxas) == set(REPORTED_KERNELS)
          and all(st == ld == 0 for _, st, ld in ptxas.values()),
          ("ptxas registers and spills", ptxas))

    b_cls, b_seg = mixed_batches()
    rows = {}
    for phase, make in (("serve", kernel_cases),
                        ("train", training_kernel_cases),
                        ("int8", int8_kernel_cases),
                        ("online", online_kernel_cases),
                        ("planted", planted_kernel_cases),
                        ("seg_train", lambda d: seg_train_cases(
                            d, tag=f" (seg steps, batch {SEG_BATCH})")),
                        ("seg_serve_int8", lambda d: seg_serve_cases(d, True)),
                        ("seg_serve_bf16",
                         lambda d: seg_serve_cases(d, False)),
                        ("mixed_cls", lambda d: seg_train_cases(
                            d, PLANTED_ARCH, b_cls,
                            tag=f" (D 384, batch {b_cls})")),
                        ("mixed_seg", lambda d: seg_train_cases(
                            d, PLANTED_ARCH, b_seg,
                            tag=f" (D 384, batch {b_seg})")),
                        ("lipro", lipro_cases),
                        # the tiny configs' widths: the train step's rows,
                        # then the bf16 and the int8 serving rows
                        ("tiny_train", lambda d: seg_train_cases(
                            d, TINY_ROW_ARCH, BATCH, tag=TINY_TAG, seed=50)),
                        ("tiny_serve_bf16", lambda d: seg_serve_cases(
                            d, False, TINY_ROW_ARCH, BATCH, seed=53,
                            tag=TINY_TAG + ", bf16 serving")),
                        ("tiny_serve_int8", lambda d: seg_serve_cases(
                            d, True, TINY_ROW_ARCH, BATCH, seed=55,
                            tag=TINY_TAG + ", int8 serving")),
                        *((f"head{d}", lambda dev, d=d: head_dim_cases(dev, d))
                          for d in HEAD_DIM_ROWS)):
        cases = make(device)
        rows[phase] = compare_kernels(cases)
        del cases
        torch.cuda.empty_cache()
    print(pair_line(rows, card), flush=True)
    for line in forward_lines(rows, card):
        print(line, flush=True)

    # phase "widths": the two tiny configs through the kernels
    t0 = time.perf_counter()
    folder = Path(tempfile.mkdtemp(prefix="chip_smoke_widths_"))
    try:
        widths = widths_phase(device, folder)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    release(device)
    print(f"phase widths: {time.perf_counter() - t0:.1f} s", flush=True)

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
    bf16_per_batch = expected
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
                                  "K11o": blocks, "K13x": blocks,
                                  "K13mm": blocks, "K14": blocks})
    int8_per_batch = expected
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
    t0 = time.perf_counter()
    accs, _ = gate(eng8, eng, device, ARCH, GATE_BATCHES,
                   GATE_BASE_SEEDS + WITNESS_BASE_SEEDS, BATCH)
    gate_s = time.perf_counter() - t0
    for seed, acc in accs.items():
        role = "gate" if seed in GATE_BASE_SEEDS else "witness"
        print(f"int8 accuracy gate, base {seed} ({role}): {report(acc)}; "
              f"lowest labels (AUROC, spread, label) {lowest_labels(acc)}",
              flush=True)
    # held at the end of the run, so that a miss still lets every later
    # phase run and print
    gate_fails = gate_verdict({s: accs[s] for s in GATE_BASE_SEEDS},
                              INT8_PROB_TOL, INT8_MIN_RANK_AUROC)
    witness_fails = gate_verdict({s: accs[s] for s in WITNESS_BASE_SEEDS},
                                 INT8_PROB_TOL, INT8_MIN_RANK_AUROC)
    print(f"int8 accuracy gate on base {GATE_BASE_SEEDS} (bounds: max "
          f"|Δprob| ≤ {INT8_PROB_TOL}, min rank AUROC ≥ "
          f"{INT8_MIN_RANK_AUROC}; {gate_s:.1f} s for "
          f"{len(accs)} bases) on {card}: "
          f"{'; '.join(gate_fails) or 'PASS'}; the witness bases against "
          f"the same bounds (printed, not bounded): "
          f"{'; '.join(witness_fails) or 'all within'}", flush=True)

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
        # real-format data on run_train's two checkpoints: preprocessing,
        # the packed store and its native reader, run_zero_shot_cls, serve
        real = real_data_phase(device, folder, rt["config"], rt["ckpts"],
                               int8_per_batch, bf16_per_batch, blocks)
        release(device)
        # real-format training: three production configs' copies over
        # generated files, then run_zero_shot_seg on folders, run_latents
        seg_int8_per_volume = expected_launches({"K4": 1, **{
            k: blocks for k in ("K9/K10", "K11y", "K11h", "K11q", "K11o",
                                "K13x", "K13mm", "K14")}})
        (folder / "realtrain").mkdir()
        rtrain = real_training_phase(device, folder / "realtrain",
                                     train_launches(blocks),
                                     seg_int8_per_volume, int8_per_batch)
        release(device)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    rt_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # run_train on planted data with the classification hook, then the
    # recipe's scoring engine; K8's D-384 rows take their launches from it
    folder = Path(tempfile.mkdtemp(prefix="chip_smoke_planted_"))
    try:
        pl = planted_phase(device, folder)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    planted_launches(pl)
    launches["planted"] = pl["launches"]

    # the segmentation paths at full width: the seg, open-seg and fusion
    # train steps (kernels against plain), seg serving through
    # run_zero_shot_seg (int8, then bf16); then configs/planted_mixed.yaml
    train_expected = train_launches(blocks)
    seg = {}
    for key, path, data_type, n_classes, n_prompts in (
            ("seg", SEG_CONFIG, "imageseg", None, 0),
            ("open-seg", OPEN_SEG_CONFIG, "imageopenseg", OPEN_SEG_PROMPTS,
             OPEN_SEG_PROMPTS),
            ("open-seg fusion", FUSION_CONFIG, "imageopenseg",
             FUSION_PROMPTS, FUSION_PROMPTS)):
        cfg = load_seg_config(path)
        check(arch_dict(cfg) == ARCH, (str(path), arch_dict(cfg)))
        seg[key] = seg_train_phase(
            device, cfg, bert, data_type, train_expected, key,
            n_classes or cfg.ct_clip_arch.seg_head.out_dim, n_prompts)
    n = SEG_SERVE_VOLUMES
    folder = Path(tempfile.mkdtemp(prefix="chip_smoke_seg_"))
    try:
        serve8, logits8 = seg_serve_phase(
            device, SEG_CONFIG, folder, True, expected_launches({
                "K4": n, **{k: n * blocks for k in (
                    "K9/K10", "K11y", "K11h", "K11q", "K11o", "K13x",
                    "K13mm", "K14")}}))
        serve16, logits16 = seg_serve_phase(
            device, SEG_CONFIG, folder, False, expected_launches({
                "K4": n, **{k: n * blocks for k in (
                    "K1", "K2x", "K2h", "K2o", "K3")}}))
        rel_8_16 = compare(logits8, logits16)[0]
        print(f"seg serving volume 0: int8 logits against bf16 logits rel "
              f"L2 {rel_8_16:.4e} (printed, not bounded)", flush=True)
        del logits8, logits16
        release(device)
        mixed = mixed_phase(device, folder)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    # the auxiliary training branches: the SSL steps, run_train on an SSL
    # config, lipro, vocabfine (its export scored at int8), the text
    # classifier
    folder = Path(tempfile.mkdtemp(prefix="chip_smoke_aux_"))
    try:
        aux = aux_phase(device, bert, folder, train_expected, int8_per_batch)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    release(device)
    # sequence and data parallelism: the ring's arithmetic at full width,
    # then run_train through the multi-host flags (an NCCL group of one)
    ring = ring_phase(device, card)
    release(device)
    folder = Path(tempfile.mkdtemp(prefix="chip_smoke_nccl_"))
    try:
        nccl = nccl_phase(device, folder, train_expected, card)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    release(device)
    # tensor parallelism's arithmetic at full width, then serve --mesh
    tp = tp_phase(device, card)
    release(device)
    serve_mesh_phase(device, card)
    release(device)
    # the legacy generative stack at GenerateCT's shapes (no kernel)
    gen = generative_phase(device, card, bert)
    for line in generative_lines(gen, card):
        print(line, flush=True)
    mixed_step = train_launches(PLANTED_ARCH["transformer_blocks"])
    print(f"planted_mixed, launches of each step type in step "
          f"{MIXED_COUNT_STEP}: {mixed['by_type']} (expected {mixed_step} "
          f"each)", flush=True)
    check(all(mixed["by_type"][t] == mixed_step for t in MIXED_TYPES),
          mixed["by_type"])
    mixed_seg = {k: mixed["by_type"]["imageseg"][k]
                 + mixed["by_type"]["imageopenseg"][k] for k in mixed_step}
    print(f"run_train: losses {rt['losses']}; ckpt_2 {rt['ckpt_gb']:.3f} GB; "
          f"resumed at step 2 bit for bit; throughput run step_time_s "
          f"{[round(t, 4) for t in rt['times']]} s; loader wait in steps "
          f"{rt['window'][0]}-{rt['window'][1]} "
          f"{[round(w, 4) for w in rt['waits']]} s", flush=True)

    # the real-format paths run the serving kernels at batch 4: the int8
    # rows with the patch embedding's, or the bf16 serving rows (copied
    # before the loop below takes the rows' counters)
    int8_rows = rows["int8"] + [r for r in rows["serve"]
                                if r["counter"] == "K4"]
    real_rows = []
    for tag, r in real["cls"]["runs"].items():
        real_rows += path_rows(rows["serve"] if "bf16" in tag else int8_rows,
                               f"run_zero_shot_cls {tag}", r["launches"])
    real_rows += path_rows(int8_rows, "serve, int8, concurrent clients",
                           real["serve"]["launches"])
    # a batch-4 training micro-step's rows: K15 and the pair over the
    # concatenated kv, K8's six (training rows), K2's three and the patch
    # embedding (serving rows, the same shapes)
    train_rows = rows["online"] + [
        r for r in rows["train"] + rows["serve"] if r["counter"] in (
            "K2x", "K2h", "K2o", "K4", "K8y", "K8dh", "K8dy", "K8dx", "K8w",
            "K8sum")]
    for name, r in rtrain["runs"].items():
        for kind, counts in r["by_type"].items():
            real_rows += path_rows(
                train_rows if kind == "imagereport" else rows["seg_train"],
                f"run_train {name} copy, the {kind} micro-steps", counts)
    real_rows += path_rows(rows["seg_serve_int8"],
                           "run_zero_shot_seg int8 on RadGenome folders",
                           rtrain["seg"]["launches"])
    real_rows += path_rows(int8_rows, "run_latents int8, batch 4",
                           rtrain["latents"]["launches"])
    # the auxiliary branches: the SSL steps and run_train's SSL step at the
    # batch-4 training rows, a VocabFine step at the batch-1 seg-step rows,
    # the export's scoring at the int8 rows, the probe at its batch-2 rows
    for t, r in aux["ssl"].items():
        real_rows += path_rows(train_rows, f"SSL step ({t}), batch {BATCH}",
                               r["launches"])
    real_rows += path_rows(train_rows, "run_train SSL copy, step 3",
                           aux["ssl_run"]["launches"])
    real_rows += path_rows(rows["seg_train"], "vocabfine step",
                           aux["vocabfine"]["launches"])
    real_rows += path_rows(int8_rows,
                           "run_zero_shot_cls int8 on the vocabfine export",
                           aux["vocabfine"]["score_launches"])
    real_rows += path_rows(rows["lipro"], "lipro fit_batch",
                           aux["lipro"]["fit_launches"])
    real_rows += path_rows(rows["lipro"], "run_finetune lipro --infer",
                           aux["lipro"]["infer_launches"])
    real_rows += ring["rows"]
    real_rows += tp["rows"]
    real_rows += path_rows(train_rows, "run_train through the multi-host "
                           "flags, NCCL group of one rank, step "
                           f"{NCCL_STEPS}", nccl["launches"])
    kernels = []
    for phase in ("serve", "train", "int8", "online", "planted"):
        for row in rows[phase]:
            row["launches"] = launches[phase][row.pop("counter")]
            kernels.append(row)
    for phase, path, counts in (
            ("seg_train", "seg step", seg["seg"]["launches"]),
            ("seg_train", "open-seg step", seg["open-seg"]["launches"]),
            ("seg_train", "open-seg fusion step",
             seg["open-seg fusion"]["launches"]),
            ("seg_serve_int8", f"run_zero_shot_seg int8, {n} volumes",
             serve8["launches"]),
            ("seg_serve_bf16", f"run_zero_shot_seg bf16, {n} volumes",
             serve16["launches"]),
            ("mixed_cls", "planted_mixed, the image-report micro-step",
             mixed["by_type"]["imagereport"]),
            ("mixed_seg", "planted_mixed, the seg and open-seg micro-steps",
             mixed_seg)):
        kernels += path_rows(rows[phase], path, counts)
    kernels += real_rows + widths_kernel_rows(rows, widths)
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
    last = pl["evals"][-1]
    print(f"run_train on planted data (dim {PLANTED_ARCH['dim']}, batch "
          f"{PLANTED_BATCH}, attn_impl=pallas, the hook every "
          f"{PLANTED_EVAL_EVERY} steps): {pl['sps']:.3f} steps/s and loader "
          f"wait {pl['wait_s']:.3f} s per batch over steps "
          f"{pl['window'][0]}-{pl['window'][1]}; one profiled step: wall "
          f"{pl['wall_ms']:.3f} ms, device busy {pl['busy_ms']:.3f} ms, idle "
          f"share {1 - pl['busy_ms'] / pl['wall_ms']:.3f}; hook {PLANTED_HOOK} "
          f"{[round(t, 3) for t in pl['hook_s']]} s a call, "
          f"{last[f'eval/{PLANTED_HOOK}/volumes_per_sec']:.3f} volumes/s; "
          f"mean AUROC at step {PLANTED_STEPS} "
          f"{last[f'eval/{PLANTED_HOOK}/mean_auc']:.4f} (printed, not "
          f"bounded); the recipe's scoring engine within "
          f"{pl['score_dprob']:.3e} of plain on {card}")
    for key, r in seg.items():
        print(f"{key} train step at full width, batch {SEG_BATCH}, "
              f"attn_impl=pallas: {1.0 / statistics.median(r['times']):.3f} "
              f"steps/s (median of {len(r['times'])} warm steps, "
              f"{[round(t, 4) for t in r['times']]} s); one profiled step: "
              f"wall {r['wall_ms']:.3f} ms, device busy {r['busy_ms']:.3f} "
              f"ms, idle share {1 - r['busy_ms'] / r['wall_ms']:.3f}; head "
              f"{r['head_ms']:.3f} ms and loss {r['loss_ms']:.3f} ms of "
              f"device time (forward and backward); peak device memory "
              f"{r['peak_gb']:.3f} GB on {card}")
    for tag, r in (("int8", serve8), ("bf16", serve16)):
        print(f"seg serving ({tag}), 1 volume, 22 classes: {r['vps']:.3f} "
              f"volumes/s (median of {len(r['times'])} warm dice calls, "
              f"{[round(t, 4) for t in r['times']]} s); one profiled call: "
              f"wall {r['wall_ms']:.3f} ms, device busy {r['busy_ms']:.3f} "
              f"ms, idle share {1 - r['busy_ms'] / r['wall_ms']:.3f}; "
              f"run_zero_shot_seg on {n} synthetic volumes {r['call_s']:.3f} "
              f"s (host data included), mean dice {r['res']['mean_dice']:.4f}"
              f" on {card}")
    print(f"run_train on configs/planted_mixed.yaml (dim 384, three loaders, "
          f"both hooks every {MIXED_EVAL_EVERY} steps): {mixed['sps']:.3f} "
          f"steps/s over steps {mixed['window'][0]}-{mixed['window'][1]}, "
          f"loader wait {mixed['wait_s']:.3f} s per batch; one profiled "
          f"step: wall {mixed['wall_ms']:.3f} ms, device busy "
          f"{mixed['busy_ms']:.3f} ms, idle share "
          f"{1 - mixed['busy_ms'] / mixed['wall_ms']:.3f}; seg hook mean "
          f"dice {[round(x, 4) for x in mixed['seg_dice']]}, cls hook mean "
          f"AUROC {[round(x, 4) for x in mixed['cls_auc']]} (printed, not "
          f"bounded); last losses "
          f"{ {k: round(v[-1], 5) for k, v in mixed['losses'].items()} } on "
          f"{card}")
    for line in real_data_lines(real, card):
        print(line)
    for line in real_training_lines(rtrain, card):
        print(line)
    for line in aux_lines(aux, card):
        print(line)
    for line in widths_lines(widths, card):
        print(line)
    check(not gate_fails, ("int8 accuracy gate", gate_fails))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
