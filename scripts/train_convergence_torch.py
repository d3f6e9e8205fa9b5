"""Learning run of the PyTorch port on the planted-signal task (counterpart
of scripts/train_convergence.py's ``planted`` mode, task "cls").

    python scripts/train_convergence_torch.py planted [steps=300]

Trains the mid-size arch (dim 384, 4 blocks of 8 heads × 32, patch 10 over
120³ voxels: 1,728 tokens; a 4-layer text tower at hidden 384) through the
port's ``CTClipTrainer`` on ``PlantedCTDataset`` (blob anatomy paired with
reports built from the zero-shot prompt sentences), on the card, with the
training kernels (K15 with lse, the backward pair, K2, K8, the patch
embedding).  It then scores ``CONV_EVAL_N`` held-out volumes of
``PlantedInferenceDataset`` with ``ZeroShotClassifier.infer`` on a serving
model built as the JAX recipe builds its own (attn_impl="pallas_static",
fuse_qkv=True: K1 and K3), prints the per-attribute AUROCs and the
mean-difference probes of the image latents (an image-side diagnostic:
fit and scored on the eval set), and requires a mean AUROC of at least
``CONV_AUROC_BOUND`` (0.8; chance is 0.5).

The train set is single-epoch (n = steps × batch): samples are made per
index, and a small set would be memorised.  A rerun resumes from the newest
checkpoint under ``CONV_OUT``, so the JAX package's recipe (its run 9) is

    python scripts/train_convergence_torch.py planted 1600
    CONV_DROP_ANY=0.25 python scripts/train_convergence_torch.py planted 2000

The run is host-bound: a 120³ planted volume takes tens of milliseconds of
one core to make, so the loader gets one worker per core.

Knobs (environment): CONV_SIZE (mid; tiny is the CPU plumbing smoke),
CONV_BATCH (32), CONV_LR (1e-4), CONV_DROP_ANY (0), CONV_TRAIN_N (steps ×
batch), CONV_EVAL_N (128), CONV_SAVE_EVERY (100), CONV_OUT
(./results/planted_signal_torch), CONV_AUROC_BOUND (0.8), CONV_CPU (run on
the CPU).  The planted segmentation modes come with the segmentation
slice.  Imports nothing of JAX or the JAX package.
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


def planted_config(steps: int, out: str, size: str, batch: int,
                   workers: int):
    """The recipe's ExperimentConfig (port schema, the JAX script's
    values)."""
    from vit_exp_tpu_torch.core.config import ExperimentConfig

    arch, text_enc = SIZES[size]
    return ExperimentConfig.from_dict({
        "random_seed": 0,
        "results_folder": out,
        "trainer": {
            "lr": _env("CONV_LR", 1e-4, float),
            "wd": 0.01,
            "num_train_steps": steps,
            "max_grad_norm": 1.0,
            "save_model_every": _env("CONV_SAVE_EVERY", 100, int),
            "eval_model_every": 0,       # scored once, after training
            "balance_loss_weight": [1.0],
        },
        "arch": arch,
        "train_data_list": [{"name": "planted", "type": "imagereport",
                             "batch_size": batch, "num_workers": workers}],
        "text_encoder": text_enc,
    })


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


def planted_main(task: str = "cls") -> None:
    if task != "cls":
        raise NotImplementedError(
            f"planted {task!r}: the planted segmentation sets and heads come "
            f"with the segmentation slice (ROADMAP M4)")
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 300
    bound = _env("CONV_AUROC_BOUND", 0.8, float)
    device = "cpu" if os.environ.get("CONV_CPU") else "cuda"
    size = _env("CONV_SIZE", "mid")
    batch = _env("CONV_BATCH", 32, int)
    out = _env("CONV_OUT", "./results/planted_signal_torch")
    workers = os.cpu_count() or 1

    from vit_exp_tpu_torch.data.planted import (PLANTED_ATTRS,
                                                PlantedCTDataset,
                                                PlantedInferenceDataset)
    from vit_exp_tpu_torch.data.tokenizer import load_tokenizer
    from vit_exp_tpu_torch.eval.zero_shot import ZeroShotClassifier
    from vit_exp_tpu_torch.models.factory import bert_config_for, build_ctclip
    from vit_exp_tpu_torch.train.trainer import CTClipTrainer

    config = planted_config(steps, out, size, batch, workers)
    tokenizer = load_tokenizer()
    bert_cfg = bert_config_for(config, tokenizer)
    model = build_ctclip(config, bert_cfg, device=device, attn_impl="pallas",
                         seed=config.random_seed)
    train_n = _env("CONV_TRAIN_N", max(64, steps * batch), int)
    train_ds = PlantedCTDataset(
        train_n, arch=config.arch, tokenizer=tokenizer, max_text_len=64,
        seed=0, drop_any_p=_env("CONV_DROP_ANY", 0.0, float))
    print(f"planted[cls]({size}): dim {config.arch.dim}/"
          f"{config.arch.transformer_blocks} blocks, {steps} steps, batch "
          f"{batch}, {workers} loader workers, drop_any_p "
          f"{train_ds.drop_any_p}, on {device}, bound {bound}", flush=True)
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
    engine = ZeroShotClassifier(eval_model, tokenizer,
                                pathologies=list(PLANTED_ATTRS),
                                max_text_len=64, batch_size=4)
    eval_n = _env("CONV_EVAL_N", 128, int)
    eval_ds = PlantedInferenceDataset(eval_n, arch=config.arch, seed=1)
    res = engine.infer(eval_ds, results_folder=out, num_workers=workers)
    res.update(image_probes(eval_model, eval_ds, PLANTED_ATTRS))
    for k, v in sorted(res.items()):
        print(f"  {k}: {v:.4f}", flush=True)
    with open(os.path.join(out, f"planted_scores_{steps}.json"), "w") as f:
        json.dump({**res, **timing, "drop_any_p": train_ds.drop_any_p,
                   "eval_n": eval_n}, f, indent=2)
    mean_auc = res["mean_auc"]
    if not (np.isfinite(mean_auc) and mean_auc >= bound):
        raise SystemExit(
            f"planted-signal AUROC {mean_auc:.4f} below the {bound} bound "
            f"(chance 0.5) at step {steps}")
    print(f"PLANTED LEARNING OK: mean AUROC {mean_auc:.4f} >= {bound} "
          f"(chance 0.5)", flush=True)


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "planted"
    tasks = {"planted": "cls", "planted_seg": "seg",
             "planted_openseg": "openseg"}
    if mode not in tasks:
        raise SystemExit(f"usage: {sys.argv[0]} planted [steps]")
    planted_main(tasks[mode])
