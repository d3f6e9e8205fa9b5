"""Learning runs of the PyTorch port on the planted-signal tasks
(counterpart of scripts/train_convergence.py's planted modes).

    python scripts/train_convergence_torch.py planted [steps=300]
    python scripts/train_convergence_torch.py planted_seg [steps=300]
    python scripts/train_convergence_torch.py planted_openseg [steps=300]

Trains the mid-size arch (dim 384, 4 blocks of 8 heads × 32, patch 10 over
120³ voxels: 1,728 tokens; a 4-layer text tower at hidden 384) through the
port's ``CTClipTrainer``, on the card, with the training kernels (K15 with
lse, the backward pair, K2, K8, the patch embedding), then scores held-out
volumes on a serving model built as the JAX recipe builds its own
(attn_impl="pallas_static", fuse_qkv=True: K1 and K3):

- ``planted`` (task "cls"): ``PlantedCTDataset`` (blob anatomy paired with
  reports built from the zero-shot prompt sentences), batch 32, lr 1e-4;
  ``ZeroShotClassifier.infer`` over ``CONV_EVAL_N`` (128) volumes of
  ``PlantedInferenceDataset``, the per-attribute AUROCs and the
  mean-difference probes of the image latents (an image-side diagnostic:
  fit and scored on the eval set); requires a mean AUROC of at least
  ``CONV_AUROC_BOUND`` (0.8; chance is 0.5).
- ``planted_seg``: ``PlantedSegDataset`` (bright and dark lesion blobs at
  uniform random places) through the closed-set step, a seg head of 2
  classes, batch 8, lr 2e-4 with 30 warmup steps; ``ZeroShotSegmenter``'s
  mean dice over ``CONV_EVAL_N`` (24) volumes of
  ``PlantedSegInferenceDataset`` (seed 1).
- ``planted_openseg``: ``PlantedOpenSegDataset`` through the
  open-vocabulary step, the fusion arm (``fusion_focal_loss``, α 0.75,
  γ 2.0; a fusion MLP 32 → 32 → 1 over [voxel, prompt] embeddings of 16
  each), down factor 2, batch 8, lr 2e-4 with 30 warmup steps; the dice of
  the fusion surface, sigmoid ≥ 0.5, against the mask downsampled by the
  factor, over ``CONV_EVAL_N`` (24) volumes of
  ``PlantedOpenSegInferenceDataset`` (seed 1).

The two segmentation tasks require a mean dice of at least
``CONV_DICE_BOUND`` (0.5; chance is near 0).  The train set is
single-epoch (n = steps × batch): samples are made per index, and a small
set would be memorised.  A rerun resumes from the newest checkpoint under
``CONV_OUT``, so the JAX package's cls recipe (its run 9) is

    python scripts/train_convergence_torch.py planted 1600
    CONV_DROP_ANY=0.25 python scripts/train_convergence_torch.py planted 2000

The runs are host-bound: a 120³ planted volume takes tens of milliseconds
of one core to make, so the loader gets one worker per core.

Knobs (environment): CONV_SIZE (mid; tiny is the CPU plumbing smoke),
CONV_BATCH (32 cls, 8 seg), CONV_LR (1e-4 cls, 2e-4 seg), CONV_WARMUP (0
cls, 30 seg), CONV_DROP_ANY (0), CONV_TRAIN_N (steps × batch), CONV_EVAL_N
(128 cls, 24 seg), CONV_SAVE_EVERY (100), CONV_OUT
(./results/planted_signal_torch, planted_seg_torch, planted_openseg_torch),
CONV_AUROC_BOUND (0.8), CONV_DICE_BOUND (0.5), CONV_CPU (run on the CPU).
Each run writes its scores, the loss curve and the timing into
``CONV_OUT``/planted_scores_{steps}.json.  Imports nothing of JAX or the
JAX package.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the mid arch of scripts/train_convergence.py, and its tiny CPU smoke
SIZES = {
    "mid": (
        {"arch_name": "ctvit_3d", "dim": 384, "image_size": 120,
         "patch_size": 10, "temporal_size": 120, "temporal_patch_size": 10,
         "transformer_blocks": 4, "dim_head": 32, "heads": 8},
        {"num_hidden_layers": 4, "hidden_size": 384,
         "num_attention_heads": 6, "intermediate_size": 1536},
    ),
    "tiny": (
        {"arch_name": "ctvit_3d", "dim": 48, "image_size": 32,
         "patch_size": 8, "temporal_size": 16, "temporal_patch_size": 4,
         "transformer_blocks": 2, "dim_head": 8, "heads": 4},
        {"num_hidden_layers": 2, "hidden_size": 32,
         "num_attention_heads": 2, "intermediate_size": 64},
    ),
}


def _env(name, default, cast=str):
    return cast(os.environ.get(name, default))


SEG_TYPES = {"cls": "imagereport", "seg": "imageseg",
             "openseg": "imageopenseg"}


def planted_config(steps: int, out: str, size: str, batch: int,
                   workers: int, task: str = "cls"):
    """The recipe's ExperimentConfig (port schema, the JAX script's
    values)."""
    from vit_exp_tpu_torch.core.config import ExperimentConfig
    from vit_exp_tpu_torch.data.planted import PLANTED_STRUCTS

    arch, text_enc = SIZES[size]
    seg = task != "cls"
    ct_clip_arch = {}
    if task == "seg":
        ct_clip_arch = {"use_seg": True,
                        "seg_head": {"out_dim": len(PLANTED_STRUCTS)}}
    elif task == "openseg":
        ct_clip_arch = {
            "use_open_seg": True,
            "open_seg_loss_type": "fusion_focal_loss",
            # focal α is the positive class's weight: ~2% of the voxels
            "open_seg_loss_hyper_config": {"alpha": 0.75, "gamma": 2.0},
            "open_seg_loss_down_factor": 2,
            "fusion_head": {"type": "mlp", "mlp": {
                "n_layers": 2, "in_dim": 32, "mid_dim": 32, "out_dim": 1}},
        }
    return ExperimentConfig.from_dict({
        "random_seed": 0,
        "results_folder": out,
        "trainer": {
            "lr": _env("CONV_LR", 2e-4 if seg else 1e-4, float),
            "warmup_steps": _env("CONV_WARMUP", 30 if seg else 0, int),
            "wd": 0.01,
            "num_train_steps": steps,
            "max_grad_norm": 1.0,
            "save_model_every": _env("CONV_SAVE_EVERY", 100, int),
            "eval_model_every": 0,       # scored once, after training
            "balance_loss_weight": [1.0],
        },
        "arch": arch,
        "ct_clip_arch": ct_clip_arch,
        "train_data_list": [{"name": "planted", "type": SEG_TYPES[task],
                             "batch_size": batch, "num_workers": workers}],
        "text_encoder": text_enc,
    })


def open_seg_dice(model, dataset, prompt_ids, prompt_mask, factor: int,
                  batch: int = 2) -> np.ndarray:
    """(N, C) dice of the fusion surface, sigmoid ≥ 0.5 of the fusion MLP
    on [voxel embedding, prompt embedding], against each mask downsampled
    by ``factor`` (NaN where a class is absent from both)."""
    from vit_exp_tpu_torch.models.ctclip import downsample_stride

    device = next(model.parameters()).device
    ids = torch.as_tensor(prompt_ids, device=device).long()
    pmask = torch.as_tensor(prompt_mask, device=device).long()
    out = []
    with torch.inference_mode():
        for i0 in range(0, len(dataset), batch):
            items = [dataset[i]
                     for i in range(i0, min(i0 + batch, len(dataset)))]
            video = torch.as_tensor(np.stack([it["image"] for it in items]),
                                    device=device)
            mask = torch.as_tensor(np.stack([it["seg_mask"] for it in items]),
                                   device=device)
            o = model.open_seg_forward(video, ids, pmask, down_factor=factor)
            sp, pl = o["seg_preds"], o["prompt_logits"]
            b, n, c = sp.shape[0], sp.shape[1], pl.shape[1]
            cat = torch.cat([sp[:, :, None, :].expand(b, n, c, sp.shape[-1]),
                             pl[:, None, :, :].expand(b, n, c, pl.shape[-1])],
                            dim=-1)
            logit = model.apply_fusion_head(cat.reshape(-1, cat.shape[-1]))
            pred = (torch.sigmoid(logit.float()).reshape(b, n, c)
                    >= 0.5).float()
            m = downsample_stride(mask, factor).float()
            t = m.permute(0, 2, 3, 4, 1).reshape(b, -1, c)
            inter = (pred * t).sum(dim=1)
            union = pred.sum(dim=1) + t.sum(dim=1)
            out.append((2.0 * inter / union).cpu().numpy())
    return np.concatenate(out)


@torch.inference_mode()
def image_probes(model, dataset, attrs, batch: int = 4):
    """Per attribute, the rank AUROC of the image latents projected on the
    difference of the class means (fit and scored on ``dataset``)."""
    from vit_exp_tpu_torch.eval.metrics import rank_auroc

    device = next(model.parameters()).device
    zs, ys = [], []
    for i0 in range(0, len(dataset), batch):
        items = [dataset[i] for i in range(i0, min(i0 + batch, len(dataset)))]
        video = torch.as_tensor(np.stack([it["image"] for it in items]),
                                device=device)
        z = model.image_latents_from_tokens(model.encode_image_tokens(video))
        zs.append(z.float().cpu().numpy())
        ys.append(np.stack([it["onehot"] for it in items]))
    z, y = np.concatenate(zs), np.concatenate(ys)
    out = {}
    for k, attr in enumerate(attrs):
        pos = y[:, k] > 0.5
        w = z[pos].mean(0) - z[~pos].mean(0)
        out[f"probe_{attr}_auc"] = rank_auroc(y[:, k], z @ w)
    return out


def loss_curve(out: str, every: int = 100) -> list:
    """[(step, mean loss over the ``every`` steps up to it)] from the run's
    metrics.jsonl (a resumed run appends to it; the newest line of a step
    wins)."""
    by_step = {}
    with open(os.path.join(out, "metrics.jsonl")) as f:
        for line in f:
            d = json.loads(line)
            if "ds0_loss" in d:
                by_step[d["step"]] = d["ds0_loss"]
    steps = sorted(by_step)
    return [(s, float(np.mean([by_step[t] for t in steps
                               if s - every < t <= s])))
            for s in steps if s % every == 0]


def score_cls(eval_model, tokenizer, config, out, workers):
    from vit_exp_tpu_torch.data.planted import (PLANTED_ATTRS,
                                                PlantedInferenceDataset)
    from vit_exp_tpu_torch.eval.zero_shot import ZeroShotClassifier

    engine = ZeroShotClassifier(eval_model, tokenizer,
                                pathologies=list(PLANTED_ATTRS),
                                max_text_len=64, batch_size=4)
    eval_n = _env("CONV_EVAL_N", 128, int)
    eval_ds = PlantedInferenceDataset(eval_n, arch=config.arch, seed=1)
    res = engine.infer(eval_ds, results_folder=out, num_workers=workers)
    res.update(image_probes(eval_model, eval_ds, PLANTED_ATTRS))
    return res, "mean_auc", eval_n


def score_seg(eval_model, config, out, workers):
    from vit_exp_tpu_torch.data.planted import PlantedSegInferenceDataset
    from vit_exp_tpu_torch.eval.zero_shot import ZeroShotSegmenter

    eval_n = _env("CONV_EVAL_N", 24, int)
    res = ZeroShotSegmenter(eval_model, batch_size=2).infer(
        PlantedSegInferenceDataset(eval_n, arch=config.arch, seed=1),
        results_folder=out, num_workers=workers)
    return res, "mean_dice", eval_n


def score_openseg(eval_model, train_ds, config, out):
    from vit_exp_tpu_torch.data.planted import (
        PLANTED_STRUCTS, PlantedOpenSegInferenceDataset)

    eval_n = _env("CONV_EVAL_N", 24, int)
    d = open_seg_dice(
        eval_model,
        PlantedOpenSegInferenceDataset(eval_n, arch=config.arch, seed=1),
        train_ds.prompt_ids, train_ds.prompt_mask,
        config.ct_clip_arch.open_seg_loss_down_factor)
    per_class = np.nanmean(d, axis=0)
    res = {f"{name}_dice": float(v)
           for name, v in zip(PLANTED_STRUCTS, per_class)}
    res["mean_dice"] = float(np.nanmean(per_class))
    np.save(os.path.join(out, "dice_scores.npy"), d)
    return res, "mean_dice", eval_n


def planted_main(task: str = "cls") -> None:
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 300
    seg = task != "cls"
    bound = (_env("CONV_DICE_BOUND", 0.5, float) if seg
             else _env("CONV_AUROC_BOUND", 0.8, float))
    device = "cpu" if os.environ.get("CONV_CPU") else "cuda"
    size = _env("CONV_SIZE", "mid")
    batch = _env("CONV_BATCH", 8 if seg else 32, int)
    out = _env("CONV_OUT", {"cls": "./results/planted_signal_torch",
                            "seg": "./results/planted_seg_torch",
                            "openseg": "./results/planted_openseg_torch"}[task])
    workers = os.cpu_count() or 1

    from vit_exp_tpu_torch.data import planted
    from vit_exp_tpu_torch.data.tokenizer import load_tokenizer
    from vit_exp_tpu_torch.models.factory import bert_config_for, build_ctclip
    from vit_exp_tpu_torch.train.trainer import CTClipTrainer

    config = planted_config(steps, out, size, batch, workers, task)
    tokenizer = load_tokenizer()
    bert_cfg = bert_config_for(config, tokenizer)
    model = build_ctclip(config, bert_cfg, device=device, attn_impl="pallas",
                         seed=config.random_seed)
    train_n = _env("CONV_TRAIN_N", max(64, steps * batch), int)
    if task == "seg":
        train_ds = planted.PlantedSegDataset(train_n, arch=config.arch,
                                             seed=0)
    elif task == "openseg":
        train_ds = planted.PlantedOpenSegDataset(
            train_n, arch=config.arch, tokenizer=tokenizer, max_text_len=64,
            seed=0)
    else:
        train_ds = planted.PlantedCTDataset(
            train_n, arch=config.arch, tokenizer=tokenizer, max_text_len=64,
            seed=0, drop_any_p=_env("CONV_DROP_ANY", 0.0, float))
    print(f"planted[{task}]({size}): dim {config.arch.dim}/"
          f"{config.arch.transformer_blocks} blocks, {steps} steps, batch "
          f"{batch}, lr {config.trainer.lr}, {workers} loader workers, on "
          f"{device}, bound {bound}", flush=True)
    trainer = CTClipTrainer(model, config, datasets=[train_ds],
                            resume_step=-1, use_wandb=False)
    start_step, t0 = trainer.step, time.perf_counter()
    status = trainer.train()
    train_s = time.perf_counter() - t0
    if status != "completed":
        print(f"training exited early ({status}); rerun to resume",
              flush=True)
        sys.exit(75)
    ran = trainer.step - start_step
    timing = {"steps": trainer.step, "steps_this_run": ran,
              "train_s": train_s,
              "steps_per_s": ran / train_s if ran else float("nan"),
              "loader_wait_per_batch_s": (trainer.data_wait_s
                                          / max(trainer.batches, 1))}
    print(f"trained steps {start_step}-{trainer.step} in {train_s:.3f} s: "
          f"{timing['steps_per_s']:.4f} steps/s, loader wait "
          f"{timing['loader_wait_per_batch_s']:.4f} s per batch", flush=True)

    # score on the serving kernels, as the JAX recipe does
    eval_model = build_ctclip(config, bert_cfg, device=device,
                              attn_impl="pallas_static", fuse_qkv=True)
    eval_model.load_state_dict(trainer.model.state_dict())
    del trainer, model
    if task == "cls":
        res, key, eval_n = score_cls(eval_model, tokenizer, config, out,
                                     workers)
    elif task == "seg":
        res, key, eval_n = score_seg(eval_model, config, out, workers)
    else:
        res, key, eval_n = score_openseg(eval_model, train_ds, config, out)
    for k, v in sorted(res.items()):
        print(f"  {k}: {v:.4f}", flush=True)
    curve = loss_curve(out)
    print(f"  loss, mean over each 100 steps: "
          f"{[(s, round(v, 5)) for s, v in curve]}", flush=True)
    with open(os.path.join(out, f"planted_scores_{steps}.json"), "w") as f:
        json.dump({**res, **timing, "loss_curve": curve, "eval_n": eval_n,
                   **({"drop_any_p": train_ds.drop_any_p}
                      if task == "cls" else {})}, f, indent=2)
    score = res[key]
    if not (np.isfinite(score) and score >= bound):
        raise SystemExit(
            f"planted[{task}] {key} {score:.4f} below the {bound} bound at "
            f"step {steps}")
    print(f"PLANTED LEARNING OK ({task}): {key} {score:.4f} >= {bound}",
          flush=True)


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "planted"
    tasks = {"planted": "cls", "planted_seg": "seg",
             "planted_openseg": "openseg"}
    if mode not in tasks:
        raise SystemExit(f"usage: {sys.argv[0]} "
                         f"{{planted,planted_seg,planted_openseg}} [steps]")
    planted_main(tasks[mode])
