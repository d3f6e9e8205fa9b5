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
- ``to_reference_state_dict(model, like=None)``: the inverse, the port's
  counterpart of the JAX package's ``export_ctclip_state_dict``: the
  port's weights plus the keys a reference CTCLIP registers and the port
  does not (``synthesized_keys``), filled as the JAX export fills them;
  ``save_reference_checkpoint`` writes it as a ``CTClip.*.pt``.
- ``from_jax_text_classifier_params(params)``: the JAX package's
  ``RadBertClassifier`` tree onto the port's (text_classifier/).
- the legacy generative stack: ``from_jax_ctvit_variables`` (the exact
  inverse of the JAX package's ``convert_ctvit_state_dict``, so its output
  is the reference CTViT layout), ``from_jax_maskgit_params`` (MaskGit, and
  SelfCritic with ``critic=True``), ``from_jax_discr_params``,
  ``from_jax_vgg_params`` (the inverse of ``convert_torchvision_vgg16``:
  torchvision's keys) and ``from_jax_fallback_params`` (the fallback
  towers, whose modules keep the JAX names).

The JAX package's msgpack files (its probe and text-classifier heads) are
not read here: there is no flax on the card's host.  Weights cross between
the packages as numpy trees through these converters.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

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
    if "mlm_head" in params:
        sd["mlm_head.weight"] = _t(params["mlm_head"]["kernel"])
        sd["mlm_head.bias"] = _f(params["mlm_head"]["bias"])
    for head in ("ssl_projector", "ssl_predictor"):
        if head in params:
            sd.update({f"{head}.{k}": val
                       for k, val in ssl_head_state(params[head]).items()})
    return sd


def ssl_head_state(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A flax ProjectionMLP/PredictionMLP tree → the port's module state:
    the module names are kept; flax's LayerNorm has ``scale``."""
    sd = {}
    for name, sub in tree.items():
        sd[name + ".weight"] = (_f(sub["scale"]) if "scale" in sub
                                else _t(sub["kernel"]))
        sd[name + ".bias"] = _f(sub["bias"])
    return sd


def from_jax_text_classifier_params(params: Dict[str, Any]
                                    ) -> Dict[str, np.ndarray]:
    """JAX RadBertClassifier params ({"encoder", "pooler", "classifier"},
    numpy leaves) → the port's RadBertClassifier state dict."""
    enc = params["encoder"]
    n_layers = sum(1 for k in enc if k.startswith("layer"))
    sd = {"encoder." + k: v for k, v in _bert(enc, n_layers).items()}
    for name in ("pooler", "classifier"):
        sd[name + ".weight"] = _t(params[name]["kernel"])
        sd[name + ".bias"] = _f(params[name]["bias"])
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


# heads the reference checkpoint layout has no place for: the JAX export
# leaves them out, and so does the port's
_NOT_EXPORTED = ("mlm_head.", "ssl_projector.", "ssl_predictor.")


def _np(v) -> np.ndarray:
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)


def to_reference_state_dict(model, *, like: Optional[Dict[str, Any]] = None
                            ) -> Dict[str, np.ndarray]:
    """The model's weights in the reference ``CTClip.*.pt`` layout (numpy
    fp32), key for key and bit for bit what the JAX package's
    ``export_ctclip_state_dict`` writes for the same parameters: the port's
    state dict (but the SSL heads) plus the synthesized keys, namely the
    sincos ``pos_embed`` (ops/posemb.py), zero βs of the γ-only LayerNorms
    and of the unused context norms (γ ones), zero-filled
    ``spatial_rel_pos_bias`` and ``to_pixels``, the ``*_latent_extra``
    mirrors of the latent projections, and a zero BERT pooler.  ``like``
    (an original reference state dict, "module." prefixed or not) gives
    the values of every synthesized key and of any key the port cannot
    derive, and pins the key set to its own."""
    from vit_exp_tpu_torch.ops.posemb import sincos_pos_embed_3d

    vt = model.visual_transformer
    dim = vt.dim
    v = "visual_transformer."
    sd = {k: _f(_np(t)) for k, t in model.state_dict().items()
          if not k.startswith(_NOT_EXPORTED)}
    synth = synthesized_keys(model)
    sd[v + "pos_embed"] = sincos_pos_embed_3d(dim, vt.grid)[None]
    sd[v + "enc_3D.norm_out.beta"] = np.zeros((dim,), np.float32)
    for i in range(len(vt.enc_3D.layers)):
        a = f"{v}enc_3D.layers.{i}.1."
        sd[a + "norm.beta"] = np.zeros((dim,), np.float32)
        sd[a + "context_norm.gamma"] = np.ones((dim,), np.float32)
        sd[a + "context_norm.beta"] = np.zeros((dim,), np.float32)
    heads = vt.enc_3D.layers[0]._modules["1"].heads
    patch_dim = sd[v + "to_patch_emb.2.weight"].shape[1]
    rel = v + "spatial_rel_pos_bias.net."
    for key, shape in (
            (rel + "0.0.weight", (dim, 2)), (rel + "0.0.bias", (dim,)),
            (rel + "1.0.weight", (dim, dim)), (rel + "1.0.bias", (dim,)),
            (rel + "2.weight", (heads, dim)), (rel + "2.bias", (heads,)),
            (v + "to_pixels.0.weight", (patch_dim, dim)),
            (v + "to_pixels.0.bias", (patch_dim,))):
        sd[key] = np.zeros(shape, np.float32)
    h = model.text_transformer.config.hidden_size
    sd["text_transformer.pooler.dense.weight"] = np.zeros((h, h), np.float32)
    sd["text_transformer.pooler.dense.bias"] = np.zeros((h,), np.float32)
    for name in ("to_text_latent", "to_visual_latent"):
        sd[f"{name}_extra.weight"] = sd[f"{name}.weight"].copy()
    if like is not None:
        if any(k.startswith("module.") for k in like):
            like = {k[len("module."):]: val for k, val in like.items()}
        for k, val in like.items():
            if k not in sd or k in synth:
                arr = _np(val)
                sd[k] = (arr.astype(np.float32)
                         if np.issubdtype(arr.dtype, np.floating) else arr)
        sd = {k: sd[k] for k in like}
    return sd


def save_reference_checkpoint(path: str, model, *,
                              like: Optional[Dict[str, Any]] = None) -> None:
    """``to_reference_state_dict`` saved as a ``CTClip.*.pt`` with every key
    "module." prefixed (the reference's load strips 7 characters from each
    key unconditionally)."""
    sd = {"module." + k: torch.from_numpy(np.array(val, copy=True, order="C"))
          for k, val in to_reference_state_dict(model, like=like).items()}
    torch.save(sd, path)


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


# -- the legacy generative stack ----------------------------------------------

def _conv_weight(kernel) -> np.ndarray:
    """flax conv kernel (*spatial, in, out) → torch (out, in, *spatial)."""
    k = _f(kernel)
    n = k.ndim - 2
    return np.ascontiguousarray(k.transpose(n + 1, n, *range(n)))


def _cosine_attention_state(a: Dict[str, Any], prefix: str
                            ) -> Dict[str, np.ndarray]:
    sd = {prefix + "norm.gamma": _f(a["norm"]["gamma"]),
          prefix + "null_kv": _f(a["null_kv"]),
          prefix + "to_q.weight": _t(a["to_q"]["kernel"]),
          prefix + "to_kv.weight": _t(a["to_kv"]["kernel"]),
          prefix + "to_out.weight": _t(a["to_out"]["kernel"]),
          prefix + "q_scale": _f(a["q_scale"]),
          prefix + "k_scale": _f(a["k_scale"])}
    if "context_norm" in a:
        sd[prefix + "context_norm.gamma"] = _f(a["context_norm"]["gamma"])
    return sd


def _geglu_state(f: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {prefix + "0.weight": _f(f["norm"]["gamma"]),
            prefix + "0.bias": _f(f["norm"]["beta"]),
            prefix + "1.weight": _t(f["wi"]["kernel"]),
            prefix + "4.weight": _t(f["wo"]["kernel"])}


def _linear_state(tree: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    sd = {prefix + "weight": _t(tree["kernel"])}
    if "bias" in tree:
        sd[prefix + "bias"] = _f(tree["bias"])
    return sd


def _ln_state(tree: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {prefix + "weight": _f(tree["gamma"]),
            prefix + "bias": _f(tree["beta"])}


def _ctvit_stack_state(p: Dict[str, Any], prefix: str
                       ) -> Dict[str, np.ndarray]:
    sd = {prefix + "norm_out.gamma": _f(p["norm_out"]["gamma"])}
    depth = sum(1 for k in p if k.startswith("attn"))
    for i in range(depth):
        layer = f"{prefix}layers.{i}."
        if f"peg{i}" in p:
            conv = p[f"peg{i}"]["dsconv"]
            sd[layer + "0.dsconv.weight"] = _conv_weight(conv["kernel"])
            sd[layer + "0.dsconv.bias"] = _f(conv["bias"])
        sd.update(_cosine_attention_state(p[f"attn{i}"], layer + "1."))
        sd.update(_geglu_state(p[f"ff{i}"], layer + "3."))
    return sd


def from_jax_ctvit_variables(variables: Dict[str, Any]
                             ) -> Dict[str, np.ndarray]:
    """JAX CTViT variables {"params", "codebook"} (numpy leaves) → the
    port's CTViT state dict, which is the reference layout
    ``convert_ctvit_state_dict`` reads (the codebook buffers with their
    leading groups axis)."""
    p, vq = variables["params"], variables["codebook"]["vq"]
    sd: Dict[str, np.ndarray] = {}
    for prefix, (n_in, proj, n_out) in (
            ("to_patch_emb_first_frame.", ("first_frame_norm_in",
                                           "first_frame_proj",
                                           "first_frame_norm_out")),
            ("to_patch_emb.", ("rest_norm_in", "rest_proj",
                               "rest_norm_out"))):
        sd.update(_ln_state(p[n_in], prefix + "1."))
        sd.update(_linear_state(p[proj], prefix + "2."))
        sd.update(_ln_state(p[n_out], prefix + "3."))
    for ours, theirs in (("enc_spatial", "enc_spatial_transformer"),
                         ("enc_temporal", "enc_temporal_transformer"),
                         ("dec_spatial", "dec_spatial_transformer"),
                         ("dec_temporal", "dec_temporal_transformer")):
        sd.update(_ctvit_stack_state(p[ours], theirs + "."))
    cpb = p["spatial_rel_pos_bias"]
    sd.update(_linear_state(cpb["net0"], "spatial_rel_pos_bias.net.0.0."))
    sd.update(_linear_state(cpb["net1"], "spatial_rel_pos_bias.net.1.0."))
    sd.update(_linear_state(cpb["to_bias"], "spatial_rel_pos_bias.net.2."))
    sd.update(_linear_state(p["to_pixels_first_frame"],
                            "to_pixels_first_frame.0."))
    sd.update(_linear_state(p["to_pixels"], "to_pixels.0."))
    sd["vq._codebook.embed"] = _f(vq["codes"])[None]
    sd["vq._codebook.cluster_size"] = _f(vq["counts"])[None]
    sd["vq._codebook.embed_avg"] = _f(vq["embed_sum"])[None]
    return sd


def from_jax_maskgit_params(params: Dict[str, Any], critic: bool = False
                            ) -> Dict[str, np.ndarray]:
    """JAX MaskGit params → the port's MaskGit state dict; with ``critic``
    a SelfCritic's params ({"net", "to_pred"}) → the port's SelfCritic."""
    if critic:
        sd = {"net." + k: v for k, v in
              from_jax_maskgit_params(params["net"]).items()}
        sd.update(_linear_state(params["to_pred"], "to_pred."))
        return sd
    sd = {"token_emb": _f(params["token_emb"]),
          "pos_emb": _f(params["pos_emb"]),
          "norm_out.gamma": _f(params["norm_out"]["gamma"]),
          "to_logits.weight": _t(params["to_logits"]["kernel"])}
    if "context_proj" in params:
        sd.update(_linear_state(params["context_proj"], "context_proj."))
    depth = sum(1 for k in params if k.startswith("block"))
    for i in range(depth):
        blk, q = params[f"block{i}"], f"blocks.{i}."
        sd.update(_cosine_attention_state(blk["self_attn"], q + "self_attn."))
        if "cross_attn" in blk:
            sd.update(_cosine_attention_state(blk["cross_attn"],
                                              q + "cross_attn."))
        sd.update(_geglu_state(blk["ff"], q + "ff."))
    return sd


def from_jax_discr_params(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """JAX SliceDiscriminator params → the port's."""
    return {f"{name}.{k}": (_conv_weight(v["kernel"]) if k == "weight"
                            else _f(v["bias"]))
            for name, v in params.items() for k in ("weight", "bias")}


def from_jax_vgg_params(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """JAX VGG16Features params → torchvision vgg16 keys (the inverse of
    the JAX package's ``convert_torchvision_vgg16``)."""
    from vit_exp_tpu_torch.models.vgg import CONV_IDX

    sd = {}
    for i, idx in enumerate(CONV_IDX):
        conv = params[f"conv{i}"]
        sd[f"features.{idx}.weight"] = _conv_weight(conv["kernel"])
        sd[f"features.{idx}.bias"] = _f(conv["bias"])
    for name, idx in (("fc6", 0), ("fc7", 3)):
        if name in params:
            sd.update(_linear_state(params[name], f"classifier.{idx}."))
    return sd


def from_jax_fallback_params(params: Dict[str, Any], prefix: str = ""
                             ) -> Dict[str, np.ndarray]:
    """A JAX fallback tower's params (TextTransformer, VisionTransformer)
    → the port's, whose modules keep the JAX names: a Dense kernel becomes
    a transposed ``weight``, an Embed table ``weight``."""
    sd = {}
    for k, v in params.items():
        if isinstance(v, dict):
            sd.update(from_jax_fallback_params(v, f"{prefix}{k}."))
        elif k == "kernel":
            sd[prefix + "weight"] = _t(v)
        elif k == "embedding":
            sd[prefix + "weight"] = _f(v)
        else:
            sd[prefix + k] = _f(v)
    return sd
