"""T5 text conditioning for the MaskGIT stack (counterpart of
vit_exp_tpu/models/t5_adapter.py).

``T5TextEncoder`` wraps transformers' torch ``T5EncoderModel``: from a
local pretrained path, or from a ``T5Config`` with weights drawn under
seed 0 (offline, shape-correct; the default is a tiny config).  Its
call returns the encoder states with the padded positions zeroed, without
gradient, and the mask.  Everything is gated on transformers being
importable (``available()``); nothing else of the port needs it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

MAX_LENGTH = 256
DEFAULT_T5_NAME = "google/t5-v1_1-base"


def available() -> bool:
    try:
        from transformers import T5EncoderModel  # noqa: F401

        return True
    except Exception:
        return False


def encoded_dim(config) -> int:
    """The conditioning width: d_model."""
    return int(config.d_model)


def tiny_config():
    from transformers import T5Config

    return T5Config(d_model=64, d_ff=128, d_kv=16, num_heads=4,
                    num_layers=2, vocab_size=512)


class T5TextEncoder:
    def __init__(self, config=None, *, pretrained: Optional[str] = None,
                 device="cuda", dtype: torch.dtype = torch.float32):
        from transformers import T5EncoderModel

        if pretrained is not None:
            self.model = T5EncoderModel.from_pretrained(pretrained,
                                                        torch_dtype=dtype)
        else:
            # transformers draws its init from the global generator: fork
            # it, so seed 0 fixes the weights and nothing else moves
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                self.model = T5EncoderModel(config or tiny_config())
            self.model = self.model.to(dtype)
        self.model = self.model.to(device).eval().requires_grad_(False)
        self.ctx_dim = encoded_dim(self.model.config)

    @torch.no_grad()
    def __call__(self, input_ids: torch.Tensor, attention_mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(b, n) ids and mask → ((b, n, d_model) states with the pads
        zeroed, the mask)."""
        dev = self.model.device
        ids = torch.as_tensor(input_ids).long().to(dev)
        mask = torch.as_tensor(attention_mask).to(dev)
        states = self.model(input_ids=ids,
                            attention_mask=mask).last_hidden_state
        states = torch.where(mask[..., None].bool(), states,
                             torch.zeros_like(states))
        return states, mask
