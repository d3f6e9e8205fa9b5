"""Data and sequence parallelism of the PyTorch port across several cards,
one process per card (the paths that one card cannot show: ring attention
with its permutes between cards, the data-parallel step's gathers and
gradient average over NCCL, the engines' gathers).

    python scripts/parallel_check_torch.py [--procs N] [--cpu]

The parent builds the kernels, runs the one-process reference on card 0,
then starts N rank processes (default: every card) with MASTER_ADDR,
MASTER_PORT, RANK, WORLD_SIZE and LOCAL_RANK set, which join one group
through ``core/multihost.py`` (NCCL on the cards).  ``--cpu`` rehearses
the same on the CPU: gloo processes, the tiny arch, the plain twins.

1. ring: q/k/v of (4, 8, 13,824, 32) bf16 and 2 null kv per head, made on
   every rank from one seed; each rank runs its shard through the
   arithmetic of ``cosine_attention(ring_group=...)`` (``ring_attention``
   on K15-with-lse chunks, the kv passed round the ring between cards,
   then ``merge_nulls``), forward and backward for a seeded cotangent.
   Rank 0 gathers the output and the q/k/v gradients (the null gradients
   summed over the ranks) and holds each within REL_L2_TOL of
   full-sequence K15 over the concatenated nulls on its own card; both
   are timed (CUDA events, the ranks between barriers).
2. step: the contrastive train step at full width (attn_impl="pallas",
   batch 4 in all, made from one seed; rank r takes its rows) with the
   data group: step 1's loss within LOSS_RTOL and its global gradient norm
   (before the clip) within GRAD_NORM_RTOL of N × the one-process step's
   on the whole batch, the parameters after it bit-equal on every rank;
   the warm step times of both (steps 2 and 3).  N ×: InfoNCE divides by
   the local batch (the reference's quirk, JAX's ``n_data_shards``), so N
   ranks' loss and gradient are N times one process's at the same global
   batch; the clip to max_grad_norm then makes the updates alike.
3. engine: ``ZeroShotClassifier`` with the group (bf16, 1 volume a rank)
   over 8 synthetic volumes: the probabilities bit for bit the
   one-process engine's at 1 volume a batch.

Prints the card line and one JSON line of the numbers; any failed check
exits non-zero.  The rank and reference outputs go to ``parallel/`` in
``chip_smoke.py``'s output directory.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import OUT_DIR  # noqa: E402

REL_L2_TOL = 1e-2
LOSS_RTOL = 1e-2
GRAD_NORM_RTOL = 0.05
BATCH, TEXT_LEN, N_VOLUMES = 4, 512, 8
CARD_ARCH = dict(dim=768, image_size=480, patch_size=20, temporal_size=240,
                 temporal_patch_size=10, transformer_blocks=8, dim_head=32,
                 heads=8, channels=1, use_flash_attention=True)
CPU_ARCH = dict(dim=24, image_size=8, patch_size=4, temporal_size=8,
                temporal_patch_size=4, transformer_blocks=2, dim_head=4,
                heads=2, channels=1, use_flash_attention=True)
TRAINER = dict(lr=1e-5, wd=0.0, max_grad_norm=0.5, warmup_steps=0,
               gradient_accumulation_steps=1)


def check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"parallel check failed: {what}")


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b).clamp_min(1e-30)).item()


def setting(cpu: bool):
    """(arch, BERT config, text length, ring shape) of the run."""
    from vit_exp_tpu_torch.models.bert import BertConfig

    if cpu:
        return (CPU_ARCH, BertConfig.tiny(), 12, (1, 2, 64, 8))
    n = (CARD_ARCH["temporal_size"] // CARD_ARCH["temporal_patch_size"]
         * (CARD_ARCH["image_size"] // CARD_ARCH["patch_size"]) ** 2)
    return (CARD_ARCH, BertConfig(), TEXT_LEN,
            (BATCH, CARD_ARCH["heads"], n, CARD_ARCH["dim_head"]))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --- 1. ring attention -------------------------------------------------------


def ring_inputs(shape, device):
    """q, k (rows of norm 4), v, the nulls and the cotangent, from one
    seed on the host, so every rank makes the same."""
    from vit_exp_tpu_torch.ops.attention import l2norm

    g = torch.Generator().manual_seed(41)
    b, h, n, d = shape
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    def randn(*s):
        return torch.randn(*s, generator=g)

    q, k = (l2norm(randn(b, h, n, d)) * 4 for _ in range(2))
    v = randn(b, h, n, d)
    nk, nv = l2norm(randn(h, 2, d)) * 4, randn(h, 2, d)
    dout = randn(b, h, n, d)
    return [t.to(device, dtype) for t in (q, k, v, nk, nv, dout)]


def ring_check(device, group, shape) -> dict:
    from vit_exp_tpu_torch.ops import flash_attention as fa
    from vit_exp_tpu_torch.ops.ring_attention import (merge_nulls,
                                                      ring_attention)
    from vit_exp_tpu_torch.parallel.collectives import gather_rows, rank, world

    q, k, v, nk, nv, dout = ring_inputs(shape, device)
    scale = 1.0 / math.sqrt(shape[-1])
    w, r = world(group), rank(group)
    n = shape[2] // w

    def shard(t):
        return t[:, :, r * n:(r + 1) * n]

    def ring_run():
        leaves = [shard(t).detach().clone().requires_grad_()
                  for t in (q, k, v)] + [t.detach().clone().requires_grad_()
                                         for t in (nk, nv)]
        out, lse = ring_attention(*leaves[:3], group=group, scale=scale,
                                  return_lse=True)
        out, _ = merge_nulls(out, lse, leaves[0], leaves[3], leaves[4], scale)
        out = out.to(v.dtype)
        out.backward(shard(dout))
        return [out.detach()] + [t.grad for t in leaves]

    def ring_ms(iters=3):
        times = []
        for _ in range(iters + 1):
            torch.distributed.barrier()
            sync(device)
            t0 = time.perf_counter()
            ring_run()
            sync(device)
            torch.distributed.barrier()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:])

    got = ring_run()
    # the shards along the tokens, in rank order; the nulls summed
    joined = [gather_rows(t.movedim(2, 0), group).movedim(0, 2)
              for t in got[:4]]
    nulls = []
    for t in got[4:]:
        t = t.contiguous()
        torch.distributed.all_reduce(t, group=group)
        nulls.append(t)
    ms = ring_ms()
    out = {"ring_ms": ms}
    if r == 0:
        def full_run():
            leaves = [t.detach().clone().requires_grad_()
                      for t in (q, k, v, nk, nv)]
            o = fa.flash_attention_online(*leaves[:3], scale=scale,
                                          null_k=leaves[3], null_v=leaves[4])
            o.backward(dout)
            return [o.detach()] + [t.grad for t in leaves]

        ref = full_run()
        errs = dict(zip(("out", "dq", "dk", "dv", "dnull_k", "dnull_v"),
                        (rel_l2(a, b) for a, b in zip(joined + nulls, ref))))
        times = []
        for _ in range(4):
            sync(device)
            t0 = time.perf_counter()
            full_run()
            sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        out.update(errors=errs, full_ms=statistics.median(times[1:]))
        check(all(math.isfinite(e) and e <= REL_L2_TOL for e in errs.values()),
              ("ring against full K15", errs))
    return out


# --- 2. the data-parallel step -----------------------------------------------


def build_step(device, arch, bert, group, attn_impl="pallas"):
    from vit_exp_tpu_torch.models.factory import build_ctclip
    from vit_exp_tpu_torch.train.optimizer import build_optimizer
    from vit_exp_tpu_torch.train.steps import make_train_steps

    model = build_ctclip(types.SimpleNamespace(**arch), bert, device=device,
                         attn_impl=attn_impl, seed=0).train()
    opt = build_optimizer(types.SimpleNamespace(**TRAINER),
                          model.parameters(), group=group)
    config = types.SimpleNamespace(ct_clip_arch=types.SimpleNamespace(
        decoupled_contrastive_learning=False))
    return model, opt, make_train_steps(model, opt, config,
                                        group=group)["imagereport"]


def global_batch(arch, vocab, text_len, device):
    g = torch.Generator().manual_seed(42)
    video = torch.randn((BATCH, 1, arch["temporal_size"], arch["image_size"],
                         arch["image_size"]), generator=g)
    ids = torch.randint(0, vocab, (BATCH, text_len), generator=g)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return {"image": video.to(device, dtype), "input_ids": ids.to(device),
            "attention_mask": torch.ones_like(ids).to(device)}


def step_run(device, arch, bert, text_len, group, rows) -> dict:
    """Step 1's loss and pre-clip gradient norm, then the warm step times
    of steps 2 and 3, and a checksum of the parameters after step 1."""
    model, opt, step = build_step(device, arch, bert, group)
    batch = {k: v[rows] for k, v in global_batch(
        arch, bert.vocab_size, text_len, device).items()}
    loss = float(step(batch, 1.0)["loss"])
    norm = float(opt.grad_norm)
    digest = torch.stack([p.detach().double().sum()
                          for p in model.parameters()]).cpu().numpy()
    times = []
    for _ in range(2):
        sync(device)
        t0 = time.perf_counter()
        float(step(batch, 1.0)["loss"])
        times.append(time.perf_counter() - t0)
    del model, opt, step
    return {"loss": loss, "grad_norm": norm, "digest": digest.tolist(),
            "step_s": times}


# --- 3. the engine -----------------------------------------------------------


def engine_probs(device, arch, bert, text_len, group, folder: Path):
    """The engine's gathered probabilities (predicted.npz from rank 0)."""
    from vit_exp_tpu_torch.data.synthetic import SyntheticInferenceDataset
    from vit_exp_tpu_torch.eval.zero_shot import ZeroShotClassifier
    from vit_exp_tpu_torch.models.factory import build_ctclip

    def tokenizer(prompts, max_length):
        g = np.random.default_rng(len(prompts))
        ids = g.integers(1, bert.vocab_size, (len(prompts), max_length))
        return {"input_ids": ids, "attention_mask": np.ones_like(ids)}

    a = types.SimpleNamespace(**arch)
    model = build_ctclip(a, bert, device=device, attn_impl="pallas_static",
                         fuse_qkv=True, seed=0)
    engine = ZeroShotClassifier(model, tokenizer, max_text_len=text_len,
                                batch_size=1, group=group)
    t0 = time.perf_counter()
    engine.infer(SyntheticInferenceDataset(N_VOLUMES, arch=a),
                 results_folder=str(folder), num_workers=1)
    return time.perf_counter() - t0


# --- the processes -----------------------------------------------------------


def reference(args) -> None:
    device = torch.device("cpu" if args.cpu else "cuda:0")
    arch, bert, text_len, _ = setting(args.cpu)
    out = {"step": step_run(device, arch, bert, text_len, None,
                            slice(0, BATCH))}
    out["engine_s"] = engine_probs(device, arch, bert, text_len, None,
                                   Path(args.out) / "engine_ref")
    (Path(args.out) / "ref.json").write_text(json.dumps(out))


def rank_main(args) -> None:
    from vit_exp_tpu_torch.core import multihost
    from vit_exp_tpu_torch.parallel.collectives import gather_objects

    dev = "cpu" if args.cpu else "cuda"
    check(multihost.initialize(device=dev), "no process group was joined")
    group = torch.distributed.group.WORLD
    device = multihost.process_device(dev)
    w, r = multihost.process_count(), multihost.process_index()
    check(BATCH % w == 0, f"batch {BATCH} over {w} ranks")
    arch, bert, text_len, shape = setting(args.cpu)
    out = {"backend": torch.distributed.get_backend(), "device": str(device)}
    out["ring"] = ring_check(device, group, shape)
    per = BATCH // w
    out["step"] = step_run(device, arch, bert, text_len, group,
                           slice(r * per, (r + 1) * per))
    digests = gather_objects(out["step"]["digest"], group)
    out["step"]["same_params"] = all(d == digests[0] for d in digests)
    out["engine_s"] = engine_probs(device, arch, bert, text_len, group,
                                   Path(args.out) / "engine_group")
    multihost.sync_hosts()
    multihost.shutdown()
    (Path(args.out) / f"rank{r}.json").write_text(json.dumps(out))


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run(cmd, env, timeout):
    res = subprocess.run(cmd, env=env, timeout=timeout, capture_output=True,
                         text=True)
    return res.returncode, res.stdout + res.stderr


def parent(args) -> int:
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.cpu:
        procs, card = args.procs or 4, "cpu (gloo)"
    else:
        if not torch.cuda.is_available():
            print("parallel_check_torch: no CUDA device (use --cpu for the "
                  "rehearsal)", file=sys.stderr)
            return 2
        from vit_exp_tpu_torch.ops import _build

        _build.build()
        procs = args.procs or torch.cuda.device_count()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    me = [sys.executable, str(Path(__file__).resolve())]
    flags = ["--out", str(out)] + (["--cpu"] if args.cpu else [])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    if args.cpu:
        env["OMP_NUM_THREADS"] = "1"
    rc, log = run(me + ["--role", "ref"] + flags, env, 900)
    (out / "ref.log").write_text(log)
    check(rc == 0, ("reference", log[-3000:]))
    port = free_port()
    children = []
    for r in range(procs):
        e = dict(env, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                 RANK=str(r), WORLD_SIZE=str(procs), LOCAL_RANK=str(r))
        children.append(subprocess.Popen(
            me + ["--role", "rank"] + flags, env=e, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in children:
            logs.append(p.communicate(timeout=900)[0])
    finally:
        for p in children:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(children, logs)):
        (out / f"rank{r}.log").write_text(log)
        check(p.returncode == 0, (f"rank {r}", log[-3000:]))

    ref = json.loads((out / "ref.json").read_text())
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(procs)]
    backend = "gloo" if args.cpu else "nccl"
    check(all(x["backend"] == backend for x in ranks),
          [x["backend"] for x in ranks])
    s0, sref = ranks[0]["step"], ref["step"]
    # InfoNCE over the local batch: N ranks give N × one process's
    loss_rel = abs(s0["loss"] - procs * sref["loss"]) / abs(procs
                                                           * sref["loss"])
    norm_rel = (abs(s0["grad_norm"] - procs * sref["grad_norm"])
                / (procs * sref["grad_norm"]))
    check(all(x["step"]["same_params"] for x in ranks),
          "the ranks' parameters differ after the step")
    check(loss_rel <= LOSS_RTOL and norm_rel <= GRAD_NORM_RTOL
          and math.isfinite(s0["loss"]), (loss_rel, norm_rel))
    a, b = (np.load(out / d / "predicted.npz")["arr_0"]
            for d in ("engine_group", "engine_ref"))
    check(a.shape == b.shape == (N_VOLUMES, 18) and np.array_equal(a, b),
          ("engine probabilities", float(np.abs(a - b).max())))
    ring = ranks[0]["ring"]
    summary = {
        "ranks": procs, "backend": backend,
        "devices": [x["device"] for x in ranks],
        "ring": {"errors": ring["errors"], "ring_ms": ring["ring_ms"],
                 "full_ms": ring["full_ms"]},
        "step": {"loss": s0["loss"], "ref_loss": sref["loss"],
                 "loss_rel": loss_rel, "grad_norm": s0["grad_norm"],
                 "ref_grad_norm": sref["grad_norm"], "norm_rel": norm_rel,
                 "step_s": s0["step_s"], "ref_step_s": sref["step_s"]},
        "engine": {"max_abs_diff": float(np.abs(a - b).max()),
                   "group_s": ranks[0]["engine_s"],
                   "ref_s": ref["engine_s"]}}
    print(f"ring attention over {procs} ranks ({backend}): errors against "
          f"full K15 {ring['errors']}; {ring['ring_ms']:.3f} ms against "
          f"{ring['full_ms']:.3f} ms on one card", flush=True)
    print(f"data-parallel step, batch {BATCH} over {procs} ranks: loss "
          f"{s0['loss']:.6f} against {procs} × {sref['loss']:.6f} (rel "
          f"{loss_rel:.2e}), grad norm {s0['grad_norm']:.5f} against "
          f"{procs} × {sref['grad_norm']:.5f} (rel {norm_rel:.2e}); warm "
          f"steps {s0['step_s']} s against {sref['step_s']} s on one "
          f"process", flush=True)
    print(card)
    print(json.dumps(summary))
    return 0


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--role", default="parent",
                   choices=["parent", "ref", "rank"])
    p.add_argument("--procs", type=int, default=0)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--out", default=str(OUT_DIR / "parallel"))
    args = p.parse_args()
    if args.role == "ref":
        reference(args)
        return 0
    if args.role == "rank":
        rank_main(args)
        return 0
    return parent(args)


if __name__ == "__main__":
    sys.exit(main())
