"""CPU parity of the port's segmentation and open-vocabulary modules against
the JAX package.

The same seeded numpy inputs and parameters go through JAX (Pallas kernels
in interpret mode) and through the port (the kernels' plain twins on CPU
tensors), all in fp32, so the two sides differ only in summation order.
Tolerances:

- unpatchify: exact (a permutation);
- module outputs (the MLP head, the seg logits, the open-seg embeddings):
  1e-5 absolute on values of order one;
- scalar losses: 1e-5 relative; their gradients in seg_preds and
  prompt_logits: relative L2 1e-5;
- dice on identical logits: exact (counts of 0/1 voxels and one fp32
  division on both sides);
- one imageseg and one imageopenseg step (the clip_focal_loss arm and the
  fusion arm) against JAX's ``make_train_steps(..., n_data_shards=1)``:
  the loss within 1e-5 relative; every updated parameter within relative
  L2 1e-5, or max |Δ| ≤ lr where its gradient is rounding noise (norm below
  NOISE = 1e-4: Adam turns noise into a step of up to lr);
- the planted and synthetic segmentation items: byte-equal.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from vit_exp_tpu.core import config as jconfig
from vit_exp_tpu.core.precision import FP32_POLICY as JAX_FP32
from vit_exp_tpu.data import planted as jplanted
from vit_exp_tpu.data import synthetic as jsynthetic
from vit_exp_tpu.data.datasets import PROMPT_TEMPLATES as JAX_TEMPLATES
from vit_exp_tpu.models import layers as jlayers
from vit_exp_tpu.models import losses as jlosses
from vit_exp_tpu.models.bert import BertConfig as JaxBertConfig
from vit_exp_tpu.models.ctclip import CTCLIP as JaxCTCLIP
from vit_exp_tpu.models.factory import build_ctclip as jax_build_ctclip
from vit_exp_tpu.ops import patches as jpatches
from vit_exp_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from vit_exp_tpu.train.steps import create_train_state
from vit_exp_tpu.train.steps import make_train_steps as jax_make_train_steps

from tests.test_torch_models import DIM_LATENT, jax_params
from tests.test_torch_slice import _tokenizer
from vit_exp_tpu_torch.core import config as tconfig
from vit_exp_tpu_torch.core.precision import FP32_POLICY
from vit_exp_tpu_torch.data import planted as tplanted
from vit_exp_tpu_torch.data import synthetic as tsynthetic
from vit_exp_tpu_torch.models import layers as tlayers
from vit_exp_tpu_torch.models import losses as tlosses
from vit_exp_tpu_torch.models.bert import BertConfig
from vit_exp_tpu_torch.models.convert import from_jax_params
from vit_exp_tpu_torch.models.factory import build_ctclip
from vit_exp_tpu_torch.ops import patches as tpatches
from vit_exp_tpu_torch.train.optimizer import build_optimizer
from vit_exp_tpu_torch.train.steps import make_train_steps

ATOL = 1e-5
RTOL = 1e-5
NOISE = 1e-4
LR = 1e-3
TEXT_LEN = 10
N_CLASSES = 3
ARCH_FIELDS = ("dim", "image_size", "patch_size", "temporal_size",
               "temporal_patch_size", "transformer_blocks", "dim_head",
               "heads", "use_flash_attention")
HEAD = {"n_layers": 2, "mid_dim": 16, "out_dim": 8}
FUSION = {"type": "mlp", "mlp": {"n_layers": 2, "in_dim": 16, "mid_dim": 8,
                                 "out_dim": 1}}


def _rel(a, b, floor=1e-30):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), floor))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _config_dict(**ct_clip_arch):
    base = _flagship_config(tiny=True)
    arch = {"use_seg": True, "seg_head": {**HEAD, "out_dim": N_CLASSES},
            "use_open_seg": True, "open_seg_head": HEAD,
            "open_text_head": HEAD, **ct_clip_arch}
    return {"trainer": {"lr": LR, "wd": 0.01, "max_grad_norm": 0.05},
            "arch": {f: getattr(base.arch, f) for f in ARCH_FIELDS},
            "ct_clip_arch": arch}


def _configs(**ct_clip_arch):
    d = _config_dict(**ct_clip_arch)
    return jconfig.ExperimentConfig.from_dict(d), \
        tconfig.ExperimentConfig.from_dict(d)


def _jax_model(config):
    return jax_build_ctclip(config, bert_config=JaxBertConfig.tiny(),
                            policy=JAX_FP32, dim_latent=DIM_LATENT,
                            attn_impl="pallas", ff_impl="pallas")


def _port_model(config, params):
    model = build_ctclip(config, BertConfig.tiny(), device="cpu",
                         policy=FP32_POLICY, dim_latent=DIM_LATENT,
                         attn_impl="pallas")
    res = model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in from_jax_params(params).items()})
    assert not res.missing_keys and not res.unexpected_keys
    return model


def _batch(config, seed, b=2):
    a = config.arch
    r = np.random.default_rng(seed)
    video = r.standard_normal(
        (b, 1, a.temporal_size, a.image_size, a.image_size)).astype(np.float32)
    mask = (r.uniform(size=(b, N_CLASSES, a.temporal_size, a.image_size,
                            a.image_size)) > 0.7).astype(np.uint8)
    ids = r.integers(1, 128, (N_CLASSES, TEXT_LEN)).astype(np.int32)
    pmask = np.ones_like(ids)
    pmask[1, 6:] = 0
    return {"image": video, "seg_mask": mask, "prompt_ids": ids,
            "prompt_mask": pmask}


# --- the pieces -----------------------------------------------------------------


def test_unpatchify_heads_matches_jax():
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 3, 4, 5, 2 * 3 * 4 * 6)).astype(np.float32)
    ref = np.asarray(jpatches.unpatchify_heads(jnp.asarray(x), 2, 3, 4))
    out = tpatches.unpatchify_heads(torch.from_numpy(x), 2, 3, 4)
    assert out.shape == ref.shape == (2, 6, 6, 12, 20)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_mlp_head_matches_jax_and_names_its_layers_as_the_reference(n_layers):
    r = np.random.default_rng(1)
    x = r.standard_normal((5, 7, 12)).astype(np.float32)
    jhead = jlayers.MLPHead(n_layers, 9, 4, policy=JAX_FP32)
    params = nn.unbox(jhead.init(jax.random.PRNGKey(n_layers),
                                 jnp.asarray(x)))["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * r.standard_normal(p.shape)
        .astype(np.float32), params)
    ref = np.asarray(jhead.apply({"params": params}, jnp.asarray(x)))
    head = tlayers.MLPHead(12, n_layers, 9, 4, policy=FP32_POLICY,
                           device="cpu")
    sd = {}
    for i in range(n_layers):
        sd[f"{2 * i}.weight"] = _t(params[f"fc{i}"]["kernel"]).t().contiguous()
        sd[f"{2 * i}.bias"] = _t(params[f"fc{i}"]["bias"])
    assert set(head.state_dict()) == set(sd)
    head.load_state_dict(sd)
    np.testing.assert_allclose(head(torch.from_numpy(x)).detach().numpy(),
                               ref, atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def models():
    """One JAX CTCLIP with all three heads (the fusion arm) at the tiny arch,
    perturbed parameters, and the port on the same parameters."""
    jcfg, tcfg = _configs(open_seg_loss_type="fusion_focal_loss",
                          fusion_head=FUSION)
    params = jax_params(jcfg, seed=13)
    return jcfg, tcfg, params, _jax_model(jcfg), _port_model(tcfg, params)


def test_the_heads_load_under_the_reference_names(models):
    _, _, params, _, model = models
    sd = from_jax_params(params)
    for head in ("seg_head", "open_seg_head", "open_text_head",
                 "fusion_head"):
        assert {f"{head}.{i}.{n}" for i in (0, 2)
                for n in ("weight", "bias")} <= set(sd), head
    assert model.seg_head[0].weight.shape == (16, 48)
    assert model.seg_head[2].weight.shape == (N_CLASSES * 4 * 8 * 8, 16)
    assert model.fusion_head[0].weight.shape == (8, 16)


def test_seg_forward_matches_jax(models):
    jcfg, _, params, jmodel, model = models
    b = _batch(jcfg, 40)
    ref = np.asarray(jax.jit(lambda p, v: jmodel.apply(
        {"params": p}, v, method=JaxCTCLIP.seg_forward))(
            params, jnp.asarray(b["image"])))
    with torch.no_grad():
        out = model.seg_forward(torch.from_numpy(b["image"]))
    assert out.shape == ref.shape == (2, N_CLASSES, 16, 32, 32)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("factor", [1, 2])
def test_open_seg_forward_matches_jax(models, factor):
    jcfg, _, params, jmodel, model = models
    b = _batch(jcfg, 41)
    ref = jax.jit(lambda p, v, i, m: jmodel.apply(
        {"params": p}, v, i, m, factor, method=JaxCTCLIP.open_seg_forward))(
            params, *(jnp.asarray(b[k]) for k in ("image", "prompt_ids",
                                                  "prompt_mask")))
    with torch.no_grad():
        out = model.open_seg_forward(
            torch.from_numpy(b["image"]),
            torch.from_numpy(b["prompt_ids"]).long(),
            torch.from_numpy(b["prompt_mask"]).long(), down_factor=factor)
    n = (16 // factor) * (32 // factor) ** 2
    assert out["seg_preds"].shape == (2, n, 8)
    assert out["prompt_logits"].shape == (2, N_CLASSES, 8)
    for k in ("seg_preds", "prompt_logits"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, rtol=0)
    concat = np.random.default_rng(2).standard_normal((7, 16)) \
        .astype(np.float32)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(concat),
                                  method=JaxCTCLIP.apply_fusion_head))
    with torch.no_grad():
        np.testing.assert_allclose(
            model.apply_fusion_head(torch.from_numpy(concat)).numpy(), ref,
            atol=ATOL, rtol=0)


def test_seg_bce_and_dice_match_jax():
    r = np.random.default_rng(3)
    logits = r.standard_normal((3, 4, 5, 6, 7)).astype(np.float32)
    logits[2, 1] = -5.0                 # class 1 of sample 2 predicted empty
    mask = (r.uniform(size=logits.shape) > 0.6).astype(np.uint8)
    mask[2, 1] = 0                      # ... and absent: a NaN dice
    ref, grad = jax.value_and_grad(jlosses.seg_bce_loss)(
        jnp.asarray(logits), jnp.asarray(mask))
    x = torch.from_numpy(logits).requires_grad_()
    loss = tlosses.seg_bce_loss(x, torch.from_numpy(mask))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref), rel=RTOL)
    assert _rel(x.grad, grad) < RTOL
    for fn in ("dice_scores_per_sample", "dice_scores"):
        ref = np.asarray(getattr(jlosses, fn)(jnp.asarray(logits),
                                              jnp.asarray(mask)))
        out = getattr(tlosses, fn)(torch.from_numpy(logits),
                                   torch.from_numpy(mask)).numpy()
        assert out.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(out, ref)
    per = tlosses.dice_scores_per_sample(torch.from_numpy(logits),
                                         torch.from_numpy(mask))
    assert torch.isnan(per[2, 1]) and int(torch.isnan(per).sum()) == 1


# --- the open-vocabulary loss family ----------------------------------------------

ARMS = ("cos_sim_l2", "clip_loss", "clip_bce_loss", "weighted_bce_loss",
        "clip_focal_loss", "tversky_loss", "fusion_focal_loss")
# the arms whose JAX function returns a per-class loss
CLASS_ARMS = ("cos_sim_l2", "weighted_bce_loss", "clip_focal_loss",
              "tversky_loss", "fusion_focal_loss")
HYPER = {"clip_loss": {"temp": 0.2}, "clip_focal_loss": {"gamma": 2,
                                                         "alpha": 0.25},
         "tversky_loss": {"alpha": 0.4, "beta": 0.6, "gamma": 1.5},
         "fusion_focal_loss": {"gamma": 2.0, "alpha": 0.75}}


def _loss_cases():
    cases = [(arm, "plain") for arm in ARMS]
    # choose_cls restricts the mask and the prompts before any arm runs
    cases += [(arm, "choose_cls") for arm in ("clip_loss", "tversky_loss",
                                              "fusion_focal_loss")]
    cases += [(arm, "class_loss") for arm in CLASS_ARMS]
    return cases


def _fusion_weights(r, h):
    return [(r.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            if len(s) == 2 else (0.1 * r.standard_normal(s)).astype(np.float32)
            for s in ((h, 8), (8,), (8, 1), (1,))]


@pytest.mark.parametrize("arm,variant", _loss_cases())
def test_open_seg_loss_matches_jax(arm, variant):
    """Value and gradient in seg_preds and prompt_logits (and, for the
    fusion arm, through the fusion MLP) of each arm, plain, restricted to
    a class subset (choose_cls), and with the per-class loss."""
    r = np.random.default_rng(ARMS.index(arm))
    B, L, C, h = 2, 30, 4, 6
    preds = r.standard_normal((B, L, h)).astype(np.float32)
    prompts = r.standard_normal((B, C, h)).astype(np.float32)
    mask = (r.uniform(size=(B, L, C)) > 0.7).astype(np.float32)
    w1, b1, w2, b2 = _fusion_weights(r, 2 * h)
    hyper = dict(HYPER.get(arm, {}))
    if variant == "choose_cls":
        hyper["choose_cls"] = [2, 0]
    want_class = variant == "class_loss"

    def jfusion(x):
        y = jax.nn.leaky_relu(x @ w1 + b1, 0.2)
        return y @ w2 + b2

    def tfusion(x):
        y = torch.nn.functional.leaky_relu(x @ _t(w1) + _t(b1), 0.2)
        return y @ _t(w2) + _t(b2)

    def jf(p, q):
        out = jlosses.open_seg_loss(p, jnp.asarray(mask), q, loss_type=arm,
                                    hyper=hyper, fusion_head_apply=jfusion,
                                    return_class_loss=want_class)
        return (out[0], out[1]) if want_class else (out, None)

    (ref, ref_class), grads = jax.value_and_grad(jf, argnums=(0, 1),
                                                 has_aux=True)(
        jnp.asarray(preds), jnp.asarray(prompts))
    p, q = _t(preds).requires_grad_(), _t(prompts).requires_grad_()
    out = tlosses.open_seg_loss(p, _t(mask), q, loss_type=arm, hyper=hyper,
                                fusion_head_apply=tfusion,
                                return_class_loss=want_class)
    loss, class_loss = out if want_class else (out, None)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref), rel=RTOL)
    assert _rel(p.grad, grads[0]) < RTOL
    assert _rel(q.grad, grads[1]) < RTOL
    if want_class:
        assert class_loss.shape == (C,)
        np.testing.assert_allclose(class_loss.detach().numpy(),
                                   np.asarray(ref_class), rtol=RTOL, atol=0)


def test_choose_cls_restricts_both_sides_and_refuses_past_the_classes():
    mask = torch.arange(24.0).reshape(1, 6, 4)
    prompts = torch.arange(12.0).reshape(1, 4, 3)
    m, p = tlosses.choose_cls(mask, prompts, [3, 1])
    assert m[0, :, 0].tolist() == mask[0, :, 3].tolist()
    assert p[0].tolist() == [prompts[0, 3].tolist(), prompts[0, 1].tolist()]
    with pytest.raises(ValueError, match="choose_cls"):
        tlosses.choose_cls(mask, prompts, [4])


def test_unknown_arm_and_a_missing_fusion_head_raise():
    x = torch.zeros(1, 2, 3)
    with pytest.raises(ValueError, match="unsupported"):
        tlosses.open_seg_loss(x, torch.zeros(1, 2, 1), x[:, :1],
                              loss_type="dice")
    with pytest.raises(ValueError, match="fusion"):
        tlosses.open_seg_loss(x, torch.zeros(1, 2, 1), x[:, :1],
                              loss_type="fusion_focal_loss")


# --- one step of each type against JAX's make_train_steps --------------------------


def _jax_step(jcfg, params, data_type, batch):
    """JAX's step at loss weight 0.5: (the metric, the weighted loss, the
    parameters after clip + AdamW on the port's names)."""
    model = _jax_model(jcfg)
    tx = jax_build_optimizer(jcfg.trainer)
    step = jax_make_train_steps(model, tx, jcfg, n_data_shards=1)[data_type]
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                               tx)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        0.5)
    metric = "seg_loss" if data_type == "imageseg" else "open_seg_loss"
    return (float(metrics[metric]), float(metrics["loss"]),
            from_jax_params(jax.tree_util.tree_map(np.asarray, new.params)))


# every case keeps the fusion head in the model (the ``models`` fixture's
# parameters); where the loss does not use it, its parameters and those of
# the unused heads get no gradient and move by AdamW's decay alone
STEP_CASES = {
    "imageseg": ("imageseg", dict(open_seg_loss_type="fusion_focal_loss")),
    "imageopenseg_clip_focal": ("imageopenseg", dict(
        open_seg_loss_type="clip_focal_loss", open_seg_loss_down_factor=2,
        open_seg_loss_hyper_config={"gamma": 2, "alpha": 0.25})),
    "imageopenseg_fusion": ("imageopenseg", dict(
        open_seg_loss_type="fusion_focal_loss", open_seg_loss_down_factor=2,
        open_seg_loss_hyper_config={"gamma": 2.0, "alpha": 0.75})),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_seg_steps_match_jax(models, case):
    data_type, arch = STEP_CASES[case]
    jcfg, tcfg = _configs(fusion_head=FUSION, **arch)
    params = models[2]
    batch = _batch(jcfg, 50)
    if data_type == "imageseg":
        batch = {k: batch[k] for k in ("image", "seg_mask")}
    value, weighted, new = _jax_step(jcfg, params, data_type, batch)

    model = _port_model(tcfg, params).train()
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    for k in ("prompt_ids", "prompt_mask"):
        if k in tbatch:
            tbatch[k] = tbatch[k].long()
    # the port's own gradients of the unweighted loss tell the tensors whose
    # gradient is rounding noise (the step's are clipped in place)
    probe = build_optimizer(tcfg.trainer, model.parameters())
    probe.step = lambda: None
    make_train_steps(model, probe, tcfg)[data_type](tbatch, 1.0)
    grads = {n: p.grad.numpy().copy() if p.grad is not None
             else np.zeros(p.shape, np.float32)
             for n, p in model.named_parameters()}
    opt = build_optimizer(tcfg.trainer, model.parameters())
    step = make_train_steps(model, opt, tcfg)[data_type]
    metrics = step(tbatch, 0.5)
    metric = "seg_loss" if data_type == "imageseg" else "open_seg_loss"
    assert set(metrics) == {metric, "loss"}
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               for v in metrics.values())
    assert float(metrics[metric]) == pytest.approx(value, rel=RTOL)
    assert float(metrics["loss"]) == pytest.approx(weighted, rel=RTOL)
    named = dict(model.named_parameters())
    assert set(named) == set(new)
    for name, p in named.items():
        if np.linalg.norm(grads[name]) < NOISE:
            assert np.abs(p.detach().numpy() - new[name]).max() <= LR, name
        else:
            assert _rel(p, new[name]) < RTOL, name


# --- data --------------------------------------------------------------------------


def _assert_same_item(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
        else:
            assert a[k] == b[k], k


def _arch(n=24):
    return dict(temporal_size=n, image_size=n)


def test_prompt_templates_match_jax():
    assert tplanted.PROMPT_TEMPLATES == JAX_TEMPLATES
    assert tplanted.PLANTED_STRUCTS == jplanted.PLANTED_STRUCTS
    assert tplanted._SEG_MASK_LEVEL == jplanted._SEG_MASK_LEVEL


@pytest.mark.parametrize("name", ["PlantedSegDataset", "PlantedOpenSegDataset",
                                  "PlantedSegInferenceDataset",
                                  "PlantedOpenSegInferenceDataset"])
def test_planted_seg_items_are_byte_equal_to_jax(name):
    kw = {}
    if name == "PlantedOpenSegDataset":
        kw = dict(tokenizer=_tokenizer(), max_text_len=12)
    jds = getattr(jplanted, name)(
        5, arch=jconfig.ArchConfig(**_arch()), seed=2, **kw)
    tds = getattr(tplanted, name)(
        5, arch=tconfig.ArchConfig(**_arch()), seed=2, **kw)
    assert len(tds) == len(jds) == 5
    for i in range(5):
        a, b = tds[i], jds[i]
        _assert_same_item(a, b)
        assert a["image"].dtype == np.float16
        assert a["seg_mask"].dtype == np.uint8
    assert any(tds[i]["seg_mask"].any() for i in range(5))


@pytest.mark.parametrize("data_type", ["imageseg", "imageopenseg"])
def test_synthetic_seg_items_are_byte_equal_to_jax(data_type):
    kw = dict(n=4, n_classes=3, seed=5, tokenizer=_tokenizer(),
              max_text_len=12)
    jds = jsynthetic.SyntheticCTDataset(
        data_type, arch=jconfig.ArchConfig(**_arch(16)), **kw)
    tds = tsynthetic.SyntheticCTDataset(
        data_type, arch=tconfig.ArchConfig(**_arch(16)), **kw)
    for i in (0, 3):
        _assert_same_item(tds[i], jds[i])
    batch = tds.collate_batch([3, 1])
    for k in ("image", "seg_mask"):
        np.testing.assert_array_equal(batch[k],
                                      np.stack([jds[3][k], jds[1][k]]))
    assert batch["seg_mask"].dtype == np.float32
    if data_type == "imageopenseg":
        np.testing.assert_array_equal(batch["prompt_ids"], jds[0]["prompt_ids"])
        with pytest.raises(ValueError, match="tokenizer"):
            tsynthetic.SyntheticCTDataset(data_type)
