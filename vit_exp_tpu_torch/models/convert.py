"""Parameters from the JAX package, and reference checkpoints.

The port's modules are named in the reference ``CTClip.*.pt`` key layout
(the layout vit_exp_tpu/models/convert.py::export_ctclip_state_dict writes),
so one ``load_state_dict`` serves both sources:

- ``from_jax_params(params)``: pure numpy; maps the JAX package's flax
  parameter tree (numpy arrays) onto exactly the keys the port registers,
  the segmentation heads' included.
  It only transposes and reshapes, so it is linear: it maps a JAX gradient
  tree (``jax.grad`` of a loss in the params) onto the port's parameter
  names as well, which is how the train-step tests compare gradients.
- ``load_reference_state_dict(model, sd)``: loads a reference-layout state
  dict with ``strict=False`` and checks that nothing is missing and that the
  unexpected keys are exactly those the reference carries for modules the
  encode path never runs (``synthesized_keys``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _f(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _t(kernel) -> np.ndarray:
    """flax kernel (in, out) → torch Linear weight (out, in)."""
    return np.ascontiguousarray(_f(kernel).T)


def _bert(p: Dict[str, Any], n_layers: int) -> Dict[str, np.ndarray]:
    sd = {
        "embeddings.word_embeddings.weight": _f(p["word_embeddings"]),
        "embeddings.position_embeddings.weight": _f(p["position_embeddings"]),
        "embeddings.token_type_embeddings.weight":
            _f(p["token_type_embeddings"]),
        "embeddings.LayerNorm.weight": _f(p["emb_norm"]["gamma"]),
        "embeddings.LayerNorm.bias": _f(p["emb_norm"]["beta"]),
    }
    for i in range(n_layers):
        lp, q = p[f"layer{i}"], f"encoder.layer.{i}"
        for name, tree in (("attention.self.query", lp["self_attn"]["query"]),
                           ("attention.self.key", lp["self_attn"]["key"]),
                           ("attention.self.value", lp["self_attn"]["value"]),
                           ("attention.output.dense", lp["attn_out"]),
                           ("intermediate.dense", lp["intermediate"]),
                           ("output.dense", lp["output"])):
            sd[f"{q}.{name}.weight"] = _t(tree["kernel"])
            sd[f"{q}.{name}.bias"] = _f(tree["bias"])
        for name, tree in (("attention.output.LayerNorm", lp["attn_norm"]),
                           ("output.LayerNorm", lp["out_norm"])):
            sd[f"{q}.{name}.weight"] = _f(tree["gamma"])
            sd[f"{q}.{name}.bias"] = _f(tree["beta"])
    return sd


def from_jax_params(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """JAX CTCLIP params (numpy leaves) → the port's state dict (numpy fp32)."""
    vis = params["visual"]
    v = "visual_transformer."
    sd = {
        v + "to_patch_emb.1.weight": _f(vis["patch_norm_in"]["gamma"]),
        v + "to_patch_emb.1.bias": _f(vis["patch_norm_in"]["beta"]),
        v + "to_patch_emb.2.weight": _t(vis["patch_proj"]["kernel"]),
        v + "to_patch_emb.2.bias": _f(vis["patch_proj"]["bias"]),
        v + "to_patch_emb.3.weight": _f(vis["patch_norm_out"]["gamma"]),
        v + "to_patch_emb.3.bias": _f(vis["patch_norm_out"]["beta"]),
        v + "enc_3D.norm_out.gamma": _f(vis["norm_out"]["gamma"]),
    }
    n_blocks = sum(1 for k in vis if k.startswith("block"))
    for i in range(n_blocks):
        attn, ff = vis[f"block{i}"]["attn"], vis[f"block{i}"]["ff"]
        a, f = f"{v}enc_3D.layers.{i}.1.", f"{v}enc_3D.layers.{i}.3."
        sd.update({
            a + "norm.gamma": _f(attn["norm"]["gamma"]),
            a + "null_kv": _f(attn["null_kv"]),
            a + "to_q.weight": _t(attn["to_q"]["kernel"]),
            a + "to_kv.weight": _t(attn["to_kv"]["kernel"]),
            a + "q_scale": _f(attn["q_scale"]),
            a + "k_scale": _f(attn["k_scale"]),
            a + "to_out.weight": _t(attn["to_out"]["kernel"]),
            f + "0.weight": _f(ff["norm"]["gamma"]),
            f + "0.bias": _f(ff["norm"]["beta"]),
            f + "1.weight": _t(ff["wi"]["kernel"]),
            f + "4.weight": _t(ff["wo"]["kernel"]),
        })
    text = params["text_transformer"]
    n_layers = sum(1 for k in text if k.startswith("layer"))
    sd.update({"text_transformer." + k: val
               for k, val in _bert(text, n_layers).items()})
    sd["to_text_latent.weight"] = _t(params["to_text_latent"]["kernel"])
    sd["to_visual_latent.weight"] = _t(params["to_visual_latent"]["kernel"])
    sd["temperature"] = _f(params["temperature"])
    # the MLP heads: fc{k} → the Sequential's Linear at index 2k
    for head in ("seg_head", "open_seg_head", "open_text_head",
                 "fusion_head"):
        for name, tree in params.get(head, {}).items():
            k = f"{head}.{2 * int(name[2:])}."
            sd[k + "weight"] = _t(tree["kernel"])
            sd[k + "bias"] = _f(tree["bias"])
    return sd


# BERT buffers older HF versions keep in the state dict; a reference
# checkpoint may or may not carry them
OPTIONAL_KEYS = frozenset({"text_transformer.embeddings.position_ids",
                           "text_transformer.embeddings.token_type_ids"})


def synthesized_keys(model) -> set:
    """Keys of a reference CTClip state dict that the port does not
    register: the fixed position table, the γ-only LayerNorms' zero β, the
    unused self-attention context norm, modules the encode path never runs,
    the BERT pooler, the latent ``*_extra`` copies, and OPTIONAL_KEYS."""
    v = "visual_transformer."
    keys = {v + "pos_embed", v + "enc_3D.norm_out.beta",
            v + "to_pixels.0.weight", v + "to_pixels.0.bias",
            "text_transformer.pooler.dense.weight",
            "text_transformer.pooler.dense.bias",
            "to_text_latent_extra.weight", "to_visual_latent_extra.weight"}
    keys |= {f"{v}spatial_rel_pos_bias.net.{k}"
             for k in ("0.0.weight", "0.0.bias", "1.0.weight", "1.0.bias",
                       "2.weight", "2.bias")}
    for i in range(len(model.visual_transformer.enc_3D.layers)):
        a = f"{v}enc_3D.layers.{i}.1."
        keys |= {a + "norm.beta", a + "context_norm.gamma",
                 a + "context_norm.beta"}
    return keys | OPTIONAL_KEYS


def load_reference_state_dict(model, state_dict: Dict[str, Any]):
    """Load a reference-layout state dict (tensors or numpy; a leading
    'module.' is stripped).  Raises unless no key is missing and the
    unexpected keys are exactly ``synthesized_keys`` (OPTIONAL_KEYS may be
    absent).  Returns the load result."""
    if any(k.startswith("module.") for k in state_dict):
        state_dict = {k[len("module."):]: val for k, val in state_dict.items()}
    sd = {k: torch.as_tensor(np.asarray(val)) if isinstance(val, np.ndarray)
          else val for k, val in state_dict.items()}
    res = model.load_state_dict(sd, strict=False)
    synth = synthesized_keys(model)
    unexpected = set(res.unexpected_keys)
    if res.missing_keys or not (
            unexpected <= synth and synth - unexpected <= OPTIONAL_KEYS):
        raise ValueError(
            f"state dict does not match the port: missing {res.missing_keys}, "
            f"unexpected beyond the synthesized set {sorted(unexpected - synth)}, "
            f"synthesized keys absent {sorted(synth - unexpected - OPTIONAL_KEYS)}")
    return res
