"""Data, sequence, parameter and tensor parallelism of the PyTorch port
across several cards, one process per card (the paths that one card
cannot show: ring attention with its permutes between cards, the
data-parallel step's gathers and gradient average over NCCL, the engines'
gathers and their one int8 k scale, the sharded parameters, the
tensor-parallel sums), and one server over every card.

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
   one-process engine's at 1 volume a batch; then (F6) the int8 engine at
   1 volume a rank bit for bit one process's int8 engine at N volumes a
   batch (the k scale over the global batch).
4. grids (core/mesh.py, parallel/sharding.py), each GRID_STEPS steps of
   the contrastive step at the global batch of 4 from one seed:
   ``4,1,1`` (data parallel) and ``1,4,1`` (parameters, gradients and
   moments sharded over the 4 cards): step 1's loss equal, its grad norm
   within FSDP_NORM_RTOL, the gathered parameters after it within
   FSDP_PARAM_RTOL (relative L2 a tensor, or 2·lr of each element for a
   tensor moved by rounding noise) of the data-parallel ones; the later
   steps' losses within FSDP_LOSS_RTOL and their grad norms printed (NCCL
   sums a reduce-scatter in another order than an all-reduce, and Adam
   turns a last-bit difference in a gradient that is rounding noise into
   a step of up to lr, so the runs part after step 1: at this random
   init the loss sits at chance and its gradient is mostly such noise);
   the parameters after the last step the same on every card; each
   card's bytes of parameters, gradients and moments between steps and
   its peak memory; ``1,1,4`` and ``2,1,2`` (tensor parallel) against the
   one-process step 1 at batch 4 (loss within LOSS_RTOL, grad norm within
   GRAD_NORM_RTOL, of D·F × one process's: InfoNCE divides by the local
   batch); every grid's warm step times.
5. serve: ``serve --mesh N,1,1 --max_batch 4N`` in the parent (one
   process, every card): 4N concurrent requests through its
   micro-batcher, each dispatched batch's int8 answers bit for bit
   ``predict_batch`` of that batch on one card; volumes/s of one batch of
   4N through the split engine and through one card.

Prints the card line and one JSON line of the numbers; any failed check
exits non-zero.  The rank and reference outputs go to ``parallel/`` in
``chip_smoke.py``'s output directory.
"""

from __future__ import annotations

import argparse
import dataclasses
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
                heads=4, channels=1, use_flash_attention=True)
GRID_STEPS = 3
FSDP_LOSS_RTOL = 1e-3
FSDP_NORM_RTOL = 1e-3
FSDP_PARAM_RTOL = 1e-5
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

    if cpu:   # 4 heads in each tower, so a model axis of 4 cuts them
        return (CPU_ARCH, BertConfig(vocab_size=128, hidden_size=36,
                                     num_hidden_layers=2,
                                     num_attention_heads=4,
                                     intermediate_size=64,
                                     max_position_embeddings=64), 12,
                (1, 2, 64, 8))
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


def engine_probs(device, arch, bert, text_len, group, folder: Path,
                 int8=False, batch_size=1):
    """The engine's gathered probabilities (predicted.npz from rank 0)."""
    from vit_exp_tpu_torch.data.synthetic import SyntheticInferenceDataset
    from vit_exp_tpu_torch.eval.zero_shot import ZeroShotClassifier
    from vit_exp_tpu_torch.models.factory import build_ctclip

    def tokenizer(prompts, max_length):
        g = np.random.default_rng(len(prompts))
        ids = g.integers(1, bert.vocab_size, (len(prompts), max_length))
        return {"input_ids": ids, "attention_mask": np.ones_like(ids)}

    a = types.SimpleNamespace(**arch)
    mode = dict(int8=True) if int8 else dict(attn_impl="pallas_static")
    model = build_ctclip(a, bert, device=device, fuse_qkv=True, seed=0,
                         **mode)
    engine = ZeroShotClassifier(model, tokenizer, max_text_len=text_len,
                                batch_size=batch_size, group=group)
    t0 = time.perf_counter()
    engine.infer(SyntheticInferenceDataset(N_VOLUMES, arch=a),
                 results_folder=str(folder), num_workers=1)
    return time.perf_counter() - t0


# --- 4. the grids --------------------------------------------------------------


def grids(n: int) -> list:
    """The grids over n ranks: data parallel, fsdp, tensor parallel and,
    for an even n of 4 or more, data × model."""
    out = [(n, 1, 1), (1, n, 1), (1, 1, n)]
    if n >= 4 and n % 2 == 0:
        out.append((2, 1, n // 2))
    return out


def local_bytes(model, opt) -> dict:
    """This card's bytes of parameters, gradients and Adam moments."""
    moments = [v for st in opt.opt.state.values() for k, v in st.items()
               if torch.is_tensor(v) and k != "step"]
    return {"params": sum(p.numel() * p.element_size()
                          for p in model.parameters()),
            "grads": sum(p.grad.numel() * p.grad.element_size()
                         for p in model.parameters() if p.grad is not None),
            "moments": sum(m.numel() * m.element_size() for m in moments)}


def grid_run(device, arch, bert, text_len, sizes, keep=False) -> dict:
    """GRID_STEPS contrastive steps on the grid ``sizes`` at the global
    batch, this rank on its batch shard: each step's loss, grad norm,
    time and this card's bytes after it; the peak memory from the
    placement on; whether every card gathers the same parameters at the
    end (and, with ``keep``, rank 0's gathered copy after step 1 on the
    host)."""
    from vit_exp_tpu_torch.core.mesh import MeshConfig, grid
    from vit_exp_tpu_torch.models.factory import build_ctclip
    from vit_exp_tpu_torch.parallel.collectives import gather_objects
    from vit_exp_tpu_torch.parallel.sharding import Sharded
    from vit_exp_tpu_torch.train.optimizer import build_optimizer
    from vit_exp_tpu_torch.train.steps import make_train_steps

    g = grid(MeshConfig(*sizes))
    model = build_ctclip(types.SimpleNamespace(**arch), bert, device=device,
                         attn_impl="pallas", seed=0).train()
    sharding = Sharded(model, g)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    opt = build_optimizer(types.SimpleNamespace(**TRAINER),
                          model.parameters(), sharding=sharding)
    config = types.SimpleNamespace(ct_clip_arch=types.SimpleNamespace(
        decoupled_contrastive_learning=False))
    step = make_train_steps(model, opt, config, group=g.batch,
                            sharding=sharding)["imagereport"]
    per = BATCH // g.batch_shards
    batch = {k: v[g.batch_index * per:(g.batch_index + 1) * per]
             for k, v in global_batch(arch, bert.vocab_size, text_len,
                                      device).items()}
    out = {"losses": [], "norms": [], "step_s": [], "bytes": []}
    for i in range(GRID_STEPS):
        sync(device)
        t0 = time.perf_counter()
        out["losses"].append(float(step(batch, 1.0)["loss"]))
        sync(device)
        out["step_s"].append(time.perf_counter() - t0)
        out["norms"].append(float(opt.grad_norm))
        out["bytes"].append(local_bytes(model, opt))
        if i == 0:
            if device.type == "cuda":
                peak = torch.cuda.max_memory_allocated(device)
            full = sharding.full_state_dict()   # every rank gathers
            if keep:
                out["full"] = {k: v.to("cpu", torch.float32, copy=True)
                               for k, v in full.items()}
            del full
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
    out["peak_gb"] = (max(peak, torch.cuda.max_memory_allocated(device))
                      / 1e9 if device.type == "cuda" else None)
    full = sharding.full_state_dict()
    digest = [float(v.double().sum()) for v in full.values()]
    digests = gather_objects(digest, torch.distributed.group.WORLD)
    out["same_params"] = all(d == digests[0] for d in digests)
    del model, opt, step, full, sharding
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def param_errors(a: dict, b: dict) -> dict:
    """name → (relative L2 of a against b, max |a − b|)."""
    return {k: (rel_l2(a[k], b[k]), float((a[k] - b[k]).abs().max()))
            for k in b}


# --- 5. serve over every card ---------------------------------------------------


def serve_check(cpu: bool, n_cards: int, out: Path) -> dict:
    """``serve --mesh N,1,1 --max_batch 4N`` (the parent: one process)
    under 4N concurrent requests through its micro-batcher; every
    dispatched batch's answers against ``predict_batch`` of that batch on
    the first card; a batch of 4N timed through the split engine and
    through one card."""
    import threading

    from vit_exp_tpu_torch.cli import serve

    arch, bert, _, _ = setting(cpu)
    cfg = out / "serve.json"
    # the tokenizer's vocabulary, at 512 positions; the default eps
    text = {k: v for k, v in dataclasses.asdict(bert).items()
            if k not in ("vocab_size", "layer_norm_eps")}
    text["max_position_embeddings"] = 512
    cfg.write_text(json.dumps({"arch": arch, "random_seed": 0,
                               "text_encoder": text}))
    n = 4 * n_cards
    args = serve.parse_args(["--config", str(cfg), "--mesh",
                             f"{n_cards},1,1", "--max_batch", str(n)])
    split, _, shape, ch = serve.build_service(args, "cpu" if cpu else "cuda")
    one = split.engines[0]
    check(len(split.engines) == n_cards, len(split.engines))
    g = torch.Generator().manual_seed(43)
    vols = torch.rand((n, ch, *shape), generator=g)
    if not cpu:   # a page-locked source, as the server's stage is
        vols = vols.pin_memory()
    vols = vols.numpy()
    dispatched = []
    predict = split.predict_batch

    def recording(volumes):
        answers = predict(volumes)
        dispatched.append((np.array(volumes), answers))
        return answers

    split.predict_batch = recording
    batcher = serve.MicroBatcher(split, max_batch=n, window_ms=200.0)
    answers = [None] * n

    def client(i):
        answers[i] = batcher.classify(vols[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    batcher.close()
    diff = max(float(np.abs(a - one.predict_batch(v)).max())
               for v, a in dispatched)
    check(diff == 0.0 and sum(len(v) for v, _ in dispatched) == n,
          ("served answers against one card", diff,
           [len(v) for v, _ in dispatched]))

    def vps(fn, reps=3):
        fn(vols)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(vols)
            times.append(time.perf_counter() - t0)
        return n / statistics.median(times)

    res = {"dispatches": [len(v) for v, _ in dispatched], "max_diff": diff,
           "split_vps": vps(predict), "one_vps": vps(one.predict_batch)}
    del split, one
    return res


# --- the processes -----------------------------------------------------------


def reference(args) -> None:
    device = torch.device("cpu" if args.cpu else "cuda:0")
    arch, bert, text_len, _ = setting(args.cpu)
    out = {"step": step_run(device, arch, bert, text_len, None,
                            slice(0, BATCH))}
    out["engine_s"] = engine_probs(device, arch, bert, text_len, None,
                                   Path(args.out) / "engine_ref")
    out["engine8_s"] = engine_probs(device, arch, bert, text_len, None,
                                    Path(args.out) / "engine8_ref", int8=True,
                                    batch_size=args.procs)
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
    out["engine8_s"] = engine_probs(device, arch, bert, text_len, group,
                                    Path(args.out) / "engine8_group",
                                    int8=True)
    out["grids"], dp_full = {}, None
    for sizes in grids(w):
        res = grid_run(device, arch, bert, text_len, sizes,
                       keep=r == 0 and sizes in ((w, 1, 1), (1, w, 1)))
        full = res.pop("full", None)
        if sizes == (w, 1, 1):
            dp_full = full
        elif full is not None:
            errs = param_errors(full, dp_full)
            worst = max(errs, key=lambda k: errs[k][0])
            res["param_rel_worst"] = [worst, *errs[worst]]
            res["param_ok"] = all(
                e[0] <= FSDP_PARAM_RTOL or e[1] <= 2 * TRAINER["lr"]
                for e in errs.values())
            res["param_noise"] = sorted(k for k, e in errs.items()
                                        if e[0] > FSDP_PARAM_RTOL)
        out["grids"][",".join(map(str, sizes))] = res
    del dp_full
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
    rc, log = run(me + ["--role", "ref", "--procs", str(procs)] + flags,
                  env, 900)
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
    a8, b8 = (np.load(out / d / "predicted.npz")["arr_0"]
              for d in ("engine8_group", "engine8_ref"))
    check(a8.shape == (N_VOLUMES, 18) and np.array_equal(a8, b8),
          ("int8 engine probabilities (F6)", float(np.abs(a8 - b8).max())))
    g0 = ranks[0]["grids"]
    dp, fsdp = g0[f"{procs},1,1"], g0[f"1,{procs},1"]
    loss_rels = [abs(a - b) / abs(b) for a, b in zip(fsdp["losses"],
                                                       dp["losses"])]
    norm_rels = [abs(a - b) / abs(b) for a, b in zip(fsdp["norms"],
                                                       dp["norms"])]
    check(fsdp["losses"][0] == dp["losses"][0]
          and max(loss_rels) <= FSDP_LOSS_RTOL
          and norm_rels[0] <= FSDP_NORM_RTOL and fsdp["param_ok"]
          and all(x["grids"][k]["same_params"] for x in ranks for k in g0),
          ("fsdp against data parallel", loss_rels, norm_rels,
           fsdp["param_rel_worst"]))
    tp = {}
    for key, res in g0.items():
        d, f, m = map(int, key.split(","))
        if m == 1:
            continue
        lr = abs(res["losses"][0] - d * f * sref["loss"]) / abs(
            d * f * sref["loss"])
        nr = abs(res["norms"][0] - d * f * sref["grad_norm"]) / (
            d * f * sref["grad_norm"])
        tp[key] = {"loss": res["losses"][0], "loss_rel": lr,
                   "grad_norm": res["norms"][0], "norm_rel": nr,
                   "step_s": res["step_s"], "peak_gb": res["peak_gb"],
                   "bytes": res["bytes"][-1]}
        check(lr <= LOSS_RTOL and nr <= GRAD_NORM_RTOL
              and all(math.isfinite(x) for x in res["losses"]),
              ("tensor parallel against one card", key, lr, nr))
    served = serve_check(args.cpu, procs, out)
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
                   "ref_s": ref["engine_s"]},
        "engine_int8": {"max_abs_diff": float(np.abs(a8 - b8).max()),
                        "group_s": ranks[0]["engine8_s"],
                        "ref_s": ref["engine8_s"]},
        "fsdp": {"losses": fsdp["losses"], "dp_losses": dp["losses"],
                 "loss_rels": loss_rels, "norms": fsdp["norms"],
                 "dp_norms": dp["norms"], "norm_rels": norm_rels,
                 "param_rel_worst": fsdp["param_rel_worst"],
                 "param_noise": fsdp["param_noise"],
                 "bytes": [x["grids"][f"1,{procs},1"]["bytes"][-1]
                           for x in ranks],
                 "dp_bytes": [x["grids"][f"{procs},1,1"]["bytes"][-1]
                              for x in ranks],
                 "peak_gb": [x["grids"][f"1,{procs},1"]["peak_gb"]
                             for x in ranks],
                 "dp_peak_gb": [x["grids"][f"{procs},1,1"]["peak_gb"]
                                for x in ranks],
                 "step_s": fsdp["step_s"], "dp_step_s": dp["step_s"]},
        "tensor_parallel": tp, "serve": served}
    print(f"ring attention over {procs} ranks ({backend}): errors against "
          f"full K15 {ring['errors']}; {ring['ring_ms']:.3f} ms against "
          f"{ring['full_ms']:.3f} ms on one card", flush=True)
    print(f"data-parallel step, batch {BATCH} over {procs} ranks: loss "
          f"{s0['loss']:.6f} against {procs} × {sref['loss']:.6f} (rel "
          f"{loss_rel:.2e}), grad norm {s0['grad_norm']:.5f} against "
          f"{procs} × {sref['grad_norm']:.5f} (rel {norm_rel:.2e}); warm "
          f"steps {s0['step_s']} s against {sref['step_s']} s on one "
          f"process", flush=True)
    print(f"int8 engine, 1 volume a rank over {procs} ranks, against one "
          f"process at {procs} a batch: max |Δprob| "
          f"{summary['engine_int8']['max_abs_diff']}",
          flush=True)
    fb = summary["fsdp"]
    print(f"fsdp 1,{procs},1 against {procs},1,1 over {GRID_STEPS} steps: "
          f"losses {fb['losses']} against {fb['dp_losses']}, grad norms "
          f"{fb['norms']} against {fb['dp_norms']} (rel {norm_rels}); "
          f"after step 1 the worst parameter {fb['param_rel_worst']}; "
          f"card 0's bytes between steps {fb['bytes'][0]} against "
          f"{fb['dp_bytes'][0]}; peak {fb['peak_gb'][0]} GB against "
          f"{fb['dp_peak_gb'][0]} GB; steps {fb['step_s']} s against "
          f"{fb['dp_step_s']} s", flush=True)
    for key, t in tp.items():
        print(f"tensor parallel {key} against one card at batch {BATCH}: "
              f"loss {t['loss']:.6f} (rel {t['loss_rel']:.2e}), grad norm "
              f"{t['grad_norm']:.5f} (rel {t['norm_rel']:.2e}); steps "
              f"{t['step_s']} s against {sref['step_s']} s on one card; "
              f"peak {t['peak_gb']} GB", flush=True)
    print(f"serve --mesh {procs},1,1 --max_batch {4 * procs}: dispatches "
          f"{served['dispatches']}, answers against predict_batch on one "
          f"card: max |Δprob| {served['max_diff']}; "
          f"{served['split_vps']:.3f} volumes/s against "
          f"{served['one_vps']:.3f} on one card", flush=True)
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
