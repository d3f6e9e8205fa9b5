"""Config-named evaluation hooks for in-training testing (counterpart of
vit_exp_tpu/eval/hooks.py).

``build_eval_hooks`` resolves the names in ``valid_test_list`` and
``sample_test_list`` to hook callables over the port's engines:

- a name holding "zero_shot_cls": the zero-shot AUROC over a validation set
  (one ``ZeroShotClassifier`` for the whole run, ``limit=10`` volumes at
  ``batch_size=2``, as the JAX package scores);
- a name holding "seg_test" (the dice hook) or a sample hook (the
  open-vocabulary maps): the segmentation slice brings them, so they raise
  ``NotImplementedError`` here, at build time;
- any other name, or a classification name without a data set: refused
  with ``ValueError``, since no hook would run for it.

A hook is ``hook(model) -> {key: value}``; the trainer logs the result
under ``eval/<name>/<key>``.
"""

from __future__ import annotations

from typing import Callable, Dict

from vit_exp_tpu_torch.eval.zero_shot import PATHOLOGIES, ZeroShotClassifier


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


def build_eval_hooks(config, tokenizer, *, cls_dataset=None,
                     cls_pathologies=None, cls_max_text_len: int = 512
                     ) -> Dict[str, Callable]:
    """Resolve config.valid_test_list / sample_test_list names.  Returns
    {name: hook} for ``CTClipTrainer``'s ``eval_hooks``.
    ``cls_pathologies`` and ``cls_max_text_len`` set the zero-shot hook's
    labels (default the 18 CT-RATE pathologies; the planted runs score the
    four planted attributes)."""
    if config.sample_test_list:
        raise NotImplementedError(
            f"sample hooks {list(config.sample_test_list)}: the open-"
            f"vocabulary sample hooks are not ported yet (ROADMAP M4)")
    eval_hooks: Dict[str, Callable] = {}
    for name in config.valid_test_list or []:
        if "seg_test" in name:
            raise NotImplementedError(
                f"eval hook {name!r}: the segmentation dice hook is not "
                f"ported yet (ROADMAP M4)")
        if "zero_shot_cls" not in name:
            raise ValueError(f"eval hook {name!r} names no hook the port "
                             f"has (a name holding 'zero_shot_cls')")
        if cls_dataset is None:
            raise ValueError(f"eval hook {name!r} needs a validation set: "
                             f"planted training data or --synthetic/"
                             f"--synthetic_eval")
        eval_hooks[name] = make_zero_shot_cls_hook(
            tokenizer, cls_dataset, pathologies=cls_pathologies,
            max_text_len=cls_max_text_len)
    return eval_hooks
