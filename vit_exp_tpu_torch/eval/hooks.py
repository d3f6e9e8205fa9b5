"""Config-named evaluation hooks for in-training testing (counterpart of
vit_exp_tpu/eval/hooks.py).

``build_eval_hooks`` resolves the names in ``valid_test_list`` and
``sample_test_list`` to hook callables over the port's engines:

- a name holding "zero_shot_cls": the zero-shot AUROC over a validation set
  (one ``ZeroShotClassifier`` for the whole run, ``limit=10`` volumes at
  ``batch_size=2``, as the JAX package scores);
- a name holding "seg_test": the closed-set dice over a segmentation set
  (one ``ZeroShotSegmenter``, ``limit=10`` volumes at batch 1);
- a sample name holding "open_seg": the open-vocabulary similarity maps of
  a few volumes as PNG slice grids (``eval/vis_hooks.py``);
- any other name, or a name without its data set: refused with
  ``ValueError``, since no hook would run for it (the JAX package skips
  such names silently).

An eval hook is ``hook(model) -> {key: value}``, logged under
``eval/<name>/<key>``; a sample hook is ``hook(model, step) -> {key:
path}``, logged under ``sample/<name>/<key>``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from vit_exp_tpu_torch.eval.zero_shot import (PATHOLOGIES, ZeroShotClassifier,
                                              ZeroShotSegmenter)


def make_zero_shot_cls_hook(tokenizer, dataset, *, pathologies=None,
                            limit: int = 10, batch_size: int = 2,
                            max_text_len: int = 512) -> Callable:
    """model → per-label AUROC dict with 'mean_auc' and 'volumes_per_sec'.
    One engine serves every call; each call drops its prompt cache, since
    the text tower has trained since."""
    pathologies = list(pathologies or PATHOLOGIES)
    box = {}

    def hook(model):
        if "engine" not in box:
            box["engine"] = ZeroShotClassifier(
                model, tokenizer, pathologies=pathologies,
                batch_size=batch_size, max_text_len=max_text_len)
        else:
            box["engine"].set_params(model)
        return box["engine"].infer(dataset, limit=limit)

    return hook


def make_seg_dice_hook(dataset, *, limit: int = 10) -> Callable:
    """model → {'dice_class_{i}', 'mean_dice'}; one engine serves every
    call."""
    box = {}

    def hook(model):
        if "engine" not in box:
            box["engine"] = ZeroShotSegmenter(model)
        else:
            box["engine"].set_params(model)
        return box["engine"].infer(dataset, limit=limit)

    return hook


def _needs(name: str, dataset, what: str) -> None:
    if dataset is None:
        raise ValueError(f"hook {name!r} needs {what}: planted training "
                         f"data, --synthetic/--synthetic_eval or the "
                         f"config's valid_data")


def build_eval_hooks(config, tokenizer, *, cls_dataset=None, seg_dataset=None,
                     open_seg_dataset=None,
                     results_folder: Optional[str] = None,
                     cls_pathologies=None, cls_max_text_len: int = 512
                     ) -> Dict[str, Dict[str, Callable]]:
    """Resolve config.valid_test_list / sample_test_list names.  Returns
    {"eval_hooks": {name: hook}, "sample_hooks": {name: hook}} for
    ``CTClipTrainer``.  ``cls_pathologies`` and ``cls_max_text_len`` set the
    zero-shot hook's labels (default the 18 CT-RATE pathologies; the
    planted runs score the four planted attributes); the sample hooks
    write under ``results_folder`` (the config's by default)/samples."""
    eval_hooks: Dict[str, Callable] = {}
    sample_hooks: Dict[str, Callable] = {}
    for name in config.valid_test_list or []:
        if "zero_shot_cls" in name:
            _needs(name, cls_dataset, "a validation set")
            eval_hooks[name] = make_zero_shot_cls_hook(
                tokenizer, cls_dataset, pathologies=cls_pathologies,
                max_text_len=cls_max_text_len)
        elif "seg_test" in name:
            _needs(name, seg_dataset, "a segmentation validation set")
            eval_hooks[name] = make_seg_dice_hook(seg_dataset)
        else:
            raise ValueError(f"eval hook {name!r} names no hook the port "
                             f"has (a name holding 'zero_shot_cls' or "
                             f"'seg_test')")
    for name in config.sample_test_list or []:
        if "open_seg" not in name:
            raise ValueError(f"sample hook {name!r} names no hook the port "
                             f"has (a name holding 'open_seg')")
        _needs(name, open_seg_dataset, "an open-vocabulary validation set")
        from vit_exp_tpu_torch.eval.vis_hooks import make_open_seg_vis_hook

        out_dir = (results_folder or config.results_folder) + "/samples"
        sample_hooks[name] = make_open_seg_vis_hook(open_seg_dataset,
                                                    out_dir=out_dir)
    return {"eval_hooks": eval_hooks, "sample_hooks": sample_hooks}
