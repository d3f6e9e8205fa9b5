"""Synthetic image-report data (counterpart of vit_exp_tpu/data/synthetic.py,
``SyntheticCTDataset`` with data_type "imagereport"): random volumes at the
exact production shapes and the batch dict layout, made in memory so
end-to-end runs need no CT-RATE data.  Item ``index`` draws from
``numpy.random.default_rng((seed, index))`` exactly as the JAX package does,
so both packages see the same bytes."""

from __future__ import annotations

from typing import Dict

import numpy as np

from vit_exp_tpu_torch.core.config import ArchConfig

_SYNTH_SENTENCES = [
    "no acute cardiopulmonary abnormality",
    "mild cardiomegaly with pericardial effusion",
    "bilateral pleural effusion and atelectasis",
    "emphysema with scattered lung nodules",
    "consolidation in the right lower lobe",
    "interlobular septal thickening noted",
]


class SyntheticCTDataset:
    def __init__(self, data_type: str = "imagereport", *, n: int = 30,
                 arch: ArchConfig | None = None, tokenizer=None,
                 max_text_len: int = 128, seed: int = 0):
        if data_type != "imagereport":
            raise NotImplementedError(
                f"synthetic {data_type!r} data is not ported yet (the "
                f"segmentation slices bring it)")
        self.data_type = data_type
        self.n = n
        self.arch = arch or ArchConfig()
        self.tokenizer = tokenizer
        self.max_text_len = max_text_len
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.default_rng((self.seed, index))
        a = self.arch
        image = rng.uniform(
            0, 1, (a.channels, a.temporal_size, a.image_size, a.image_size)
        ).astype(np.float32)
        text = _SYNTH_SENTENCES[index % len(_SYNTH_SENTENCES)]
        item: Dict = {"image": image, "data_type": self.data_type,
                      "text": text}
        if self.tokenizer is not None:
            toks = self.tokenizer([text], max_length=self.max_text_len)
            item["input_ids"] = toks["input_ids"][0]
            item["attention_mask"] = toks["attention_mask"][0]
        return item
