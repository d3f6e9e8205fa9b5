"""Report → multi-label classifier (counterpart of
vit_exp_tpu/text_classifier/classifier.py): the port's BERT (``encoder``),
a pooler (tanh of a Linear on the CLS state) and a Linear head, in fp32.

``load_hf_radbert`` reads an HF RoBERTa/BERT state dict (RadBERT is
RoBERTa-based) into the port's layout directly: the ``model.`` prefix and
``roberta.`` are stripped, a ``bert.`` prefix is read through, and for
RoBERTa the first two rows of the position table (pad-reserved: RoBERTa's
positions start at padding_idx + 1 = 2) are dropped, which is exact for
trailing padding.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from vit_exp_tpu_torch.core.precision import FP32_POLICY, Policy
from vit_exp_tpu_torch.models.bert import BertConfig, BertModel
from vit_exp_tpu_torch.models.layers import Linear


class RadBertClassifier(nn.Module):
    def __init__(self, config: BertConfig, n_classes: int = 18, *,
                 policy: Policy = FP32_POLICY, device=None):
        super().__init__()
        kw = dict(policy=policy, device=device)
        self.config, self.n_classes = config, n_classes
        self.encoder = BertModel(config, **kw)
        self.pooler = Linear(config.hidden_size, config.hidden_size, **kw)
        self.classifier = Linear(config.hidden_size, n_classes, **kw)

    def forward(self, input_ids: torch.Tensor,
                attention_mask=None) -> torch.Tensor:
        hidden = self.encoder(input_ids, attention_mask)
        return self.classifier(torch.tanh(self.pooler(hidden[:, 0, :])))


def load_hf_radbert(state_dict: Dict[str, Any], config: BertConfig,
                    n_classes: int, roberta: bool = True
                    ) -> Dict[str, torch.Tensor]:
    """An HF roberta/bert state dict (with or without a ``classifier.*``
    head) → the port's RadBertClassifier state dict (fp32 tensors); the
    pooler and the head where the HF dict has them (load the rest of a
    model with ``strict=False``).  ``n_classes`` names the head's width."""

    def get(sd, key):
        for k in (key, "bert." + key):
            if k in sd:
                v = sd[k]
                return torch.as_tensor(np.asarray(
                    v.detach().cpu().numpy() if hasattr(v, "detach") else v),
                    dtype=torch.float32)
        raise KeyError(key)

    prefix = "model." if any(k.startswith("model.") for k in state_dict) else ""
    enc_sd = {k[len(prefix):].replace("roberta.", ""): v
              for k, v in state_dict.items() if not k.startswith("classifier")}
    names = BertModel(config, device="meta").state_dict().keys()
    out = {"encoder." + k: get(enc_sd, k) for k in names}
    if roberta:
        key = "encoder.embeddings.position_embeddings.weight"
        out[key] = out[key][2:2 + config.max_position_embeddings].clone()
    for pool_key in ("pooler.dense", "bert.pooler.dense"):
        if f"{prefix}{pool_key}.weight" in state_dict:
            out["pooler.weight"] = get(state_dict, f"{prefix}{pool_key}.weight")
            out["pooler.bias"] = get(state_dict, f"{prefix}{pool_key}.bias")
            break
    if "classifier.weight" in state_dict:
        out["classifier.weight"] = get(state_dict, "classifier.weight")
        out["classifier.bias"] = get(state_dict, "classifier.bias")
        if out["classifier.weight"].shape[0] != n_classes:
            raise ValueError(f"the head has {out['classifier.weight'].shape[0]}"
                             f" classes, not {n_classes}")
    return out
