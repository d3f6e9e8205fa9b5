"""CPU parity of the port's ``ct_clip_arch`` switches against the JAX package.

``fix_text_encoder``: JAX stops the gradient at the text tower's hidden
states (``jax.lax.stop_gradient``); the port detaches them.  One image-report
step at the tiny flagship arch, from the same seeded numpy parameters and
batch, against JAX's ``make_train_steps(..., n_data_shards=1)``
(attn_impl="pallas", ff_impl="pallas", Pallas in interpret mode), all fp32.
wd is 0.01, so AdamW's decay moves BERT's matrices on a zero gradient on both
sides: the port's optimizer fills a missing ``.grad`` with zeros, as optax
steps a stopped gradient.  Tolerances (those of tests/test_torch_train.py):

- the step's loss within 1e-5 relative;
- BERT's gradients exactly zero on both sides (the port's are None: no
  graph reaches them);
- every other gradient within relative L2 1e-4 per tensor (fp32 sums in
  another order), floored at NOISE = 1e-4 for rounding-noise gradients;
- every updated parameter within relative L2 1e-5, or max |Δ| ≤ lr where
  its gradient is noise (Adam turns noise into a step of up to lr).

``use_seg`` and ``use_open_seg`` build their heads (ported with the
segmentation slice).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from vit_exp_tpu.core import config as jconfig
from vit_exp_tpu.core.precision import FP32_POLICY as JAX_FP32
from vit_exp_tpu.models import losses as jlosses
from vit_exp_tpu.models.bert import BertConfig as JaxBertConfig
from vit_exp_tpu.models.factory import build_ctclip as jax_build_ctclip
from vit_exp_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from vit_exp_tpu.train.steps import create_train_state
from vit_exp_tpu.train.steps import make_train_steps as jax_make_train_steps

from tests.test_torch_models import DIM_LATENT, jax_params
from vit_exp_tpu_torch.core import config as tconfig
from vit_exp_tpu_torch.core.precision import FP32_POLICY
from vit_exp_tpu_torch.models import losses as tlosses
from vit_exp_tpu_torch.models.bert import BertConfig
from vit_exp_tpu_torch.models.convert import from_jax_params
from vit_exp_tpu_torch.models.factory import build_ctclip
from vit_exp_tpu_torch.train.optimizer import build_optimizer
from vit_exp_tpu_torch.train.steps import make_train_steps

GRAD_TOL = 1e-4
NOISE = 1e-4
TEXT_LEN = 14
LR = 1e-3
ARCH_FIELDS = ("dim", "image_size", "patch_size", "temporal_size",
               "temporal_patch_size", "transformer_blocks", "dim_head",
               "heads", "use_flash_attention")


def _rel(a, b, floor=1e-30):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), floor))


def _config_dict(**ct_clip_arch):
    base = _flagship_config(tiny=True)
    return {"trainer": {"lr": LR, "wd": 0.01, "max_grad_norm": 0.05},
            "arch": {f: getattr(base.arch, f) for f in ARCH_FIELDS},
            "ct_clip_arch": ct_clip_arch}


def _port_model(config, params):
    model = build_ctclip(config, BertConfig.tiny(), device="cpu",
                         policy=FP32_POLICY, dim_latent=DIM_LATENT,
                         attn_impl="pallas")
    res = model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in from_jax_params(params).items()})
    assert not res.missing_keys and not res.unexpected_keys
    return model.train()


@pytest.fixture(scope="module")
def jax_fixed_step():
    """JAX's image-report step with fix_text_encoder: its loss, the
    gradients (value_and_grad of the same loss) and the parameters after
    clip + AdamW."""
    d = _config_dict(fix_text_encoder=True)
    config = jconfig.ExperimentConfig.from_dict(d)
    assert config.ct_clip_arch.fix_text_encoder
    params = jax_params(config, seed=11)
    model = jax_build_ctclip(config, bert_config=JaxBertConfig.tiny(),
                             policy=JAX_FP32, dim_latent=DIM_LATENT,
                             attn_impl="pallas", ff_impl="pallas")
    a = config.arch
    r = np.random.default_rng(31)
    video = r.standard_normal(
        (2, 1, a.temporal_size, a.image_size, a.image_size)).astype(np.float32)
    ids = r.integers(0, 128, (2, TEXT_LEN)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, 10:] = 0
    batch = {"image": jnp.asarray(video), "input_ids": jnp.asarray(ids),
             "attention_mask": jnp.asarray(mask)}

    def loss_fn(p):
        out = model.apply({"params": p}, batch["image"], batch["input_ids"],
                          batch["attention_mask"])
        return jlosses.infonce_loss(out["text_latents"], out["image_latents"],
                                    out["temperature"], local_batch_size=2)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = jax_build_optimizer(config.trainer)
    step = jax_make_train_steps(model, tx, config,
                                n_data_shards=1)["imagereport"]
    state, metrics = step(create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), tx), batch, 1.0)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return dict(config=tconfig.ExperimentConfig.from_dict(d), params=params,
                video=video, ids=ids, mask=mask, loss=float(loss),
                step_loss=float(metrics["loss"]),
                grads=from_jax_params(to_np(grads)),
                new=from_jax_params(to_np(state.params)))


def test_fixed_text_encoder_step_matches_jax(jax_fixed_step):
    j = jax_fixed_step
    assert j["config"].ct_clip_arch.fix_text_encoder
    model = _port_model(j["config"], j["params"])
    assert model.clip_arch.fix_text_encoder
    video, ids, mask = (torch.from_numpy(j[k]) for k in ("video", "ids",
                                                          "mask"))
    ids = ids.long()
    named = dict(model.named_parameters())
    bert = {n for n in named if n.startswith("text_transformer.")}
    assert bert and set(named) == set(j["grads"])

    out = model(video, ids, mask)
    loss = tlosses.infonce_loss(out["text_latents"], out["image_latents"],
                                out["temperature"], local_batch_size=2)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(j["loss"], rel=1e-5)
    for name, p in named.items():
        if name in bert:
            assert p.grad is None, name
            assert not np.any(j["grads"][name]), name
        else:
            assert p.grad is not None, name
            assert _rel(p.grad, j["grads"][name], NOISE) < GRAD_TOL, name

    old = {n: p.detach().clone() for n, p in named.items()}
    opt = build_optimizer(j["config"].trainer, model.parameters())
    step = make_train_steps(model, opt, j["config"])["imagereport"]
    metrics = step({"image": video, "input_ids": ids,
                    "attention_mask": mask}, 1.0)
    assert float(metrics["loss"]) == pytest.approx(j["step_loss"], rel=1e-5)
    moved = 0
    for name, p in named.items():
        if name in bert:
            assert torch.count_nonzero(p.grad) == 0, name
        if np.linalg.norm(j["grads"][name]) < NOISE:
            assert np.abs(p.detach().numpy() - j["new"][name]).max() <= LR, \
                name
        else:
            assert _rel(p, j["new"][name]) < 1e-5, name
        if name in bert and not torch.equal(p.detach(), old[name]):
            # AdamW's decay on a zero gradient, exactly as optax's
            assert p.ndim >= 2, name
            assert _rel(p, j["new"][name]) < 1e-5, name
            moved += 1
    assert moved > 0


def test_text_encoder_trains_without_the_switch():
    """The default config leaves BERT's gradient on (the switch is what
    detaches it, not the port)."""
    config = tconfig.ExperimentConfig.from_dict(_config_dict())
    model = build_ctclip(config, BertConfig.tiny(), device="cpu",
                         policy=FP32_POLICY, dim_latent=DIM_LATENT)
    assert not model.clip_arch.fix_text_encoder
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 128, (2, 9)))
    model.text_latents_from_hidden(model.encode_text_hidden(ids)).sum() \
        .backward()
    grads = [p.grad for p in model.text_transformer.parameters()]
    assert all(g is not None for g in grads)
    assert any(bool(g.abs().max() > 0) for g in grads)


@pytest.mark.parametrize("switch", ["use_seg", "use_open_seg"])
def test_build_refuses_unported_heads(switch):
    """The seg and open-seg heads are ported now: each switch builds its
    heads and nothing else (tests/test_torch_seg.py holds them to JAX)."""
    config = tconfig.ExperimentConfig.from_dict(_config_dict(**{switch: True}))
    assert getattr(config.ct_clip_arch, switch)
    model = build_ctclip(config, BertConfig.tiny(), device="cpu",
                         dim_latent=DIM_LATENT)
    heads = {n.split(".")[0] for n, _ in model.named_parameters()
             if "_head" in n.split(".")[0]}
    assert heads == ({"seg_head"} if switch == "use_seg"
                     else {"open_seg_head", "open_text_head"})
