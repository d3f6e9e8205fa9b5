"""CPU parity of the port's training entry point (config, tokenizers,
synthetic data, loader, samplers, gradient accumulation, CTClipTrainer,
checkpoints, run_train) against the JAX package, on the same seeds.

The slice: three optimizer steps of the port's ``CTClipTrainer`` (two data
micro-steps per step, gradient_accumulation_steps 2, wd 0.01) from JAX's
parameters, against the JAX package's step functions
(``make_train_steps(..., n_data_shards=1)``, attn_impl="pallas" and
ff_impl="pallas" with Pallas in interpret mode) fed from the JAX package's
Loader and sampler.  The JAX ``CTClipTrainer`` itself is not the oracle
there: it spreads its batch over all 8 CPU devices of the test process.
Everything runs in fp32.  Tolerances:

- each micro-step's cl_loss within 1e-5 relative (tests/test_torch_train.py);
- the parameters after each update u (u = 1, 2, 3) within relative L2
  1e-5 per tensor, the bound that file holds one step to.  lr is 1e-4
  (the tiny flagship config's): Adam divides each element by its own
  gradient scale, so an element whose gradient is rounding noise moves by
  up to lr per update on each side, whatever its tensor's norm; at
  lr 1e-3 one such element of a BERT bias alone puts that tensor at
  1.4e-5.  A tensor whose gradient norm stays below NOISE = 1e-4 on every
  micro-step (as that file floors it) is noise as a whole, and is held to
  max |Δ| ≤ u·lr;
- optax.MultiSteps against the port's accumulation: 1e-6 relative (the
  same fp32 elementwise arithmetic, AdamW's decay written another way);
- loader bytes, tokenizer ids, sampler draws, config fields and restored
  checkpoints: exact.
"""

import dataclasses
import json
import math
import shutil
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_exp_tpu.core import config as jconfig
from vit_exp_tpu.core.precision import FP32_POLICY as JAX_FP32
from vit_exp_tpu.data import loader as jloader
from vit_exp_tpu.data import synthetic as jsynthetic
from vit_exp_tpu.data import tokenizer as jtokenizer
from vit_exp_tpu.models.bert import BertConfig as JaxBertConfig
from vit_exp_tpu.models.factory import build_ctclip as jax_build_ctclip
from vit_exp_tpu.train import sampler as jsampler
from vit_exp_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from vit_exp_tpu.train.steps import create_train_state
from vit_exp_tpu.train.steps import make_train_steps as jax_make_train_steps

from tests.test_torch_models import DIM_LATENT, jax_params
from vit_exp_tpu_torch.cli import run_train
from vit_exp_tpu_torch.core import config as tconfig
from vit_exp_tpu_torch.core.mesh import MeshError
from vit_exp_tpu_torch.core.precision import FP32_POLICY
from vit_exp_tpu_torch.data import loader as tloader
from vit_exp_tpu_torch.data import synthetic as tsynthetic
from vit_exp_tpu_torch.data import tokenizer as ttokenizer
from vit_exp_tpu_torch.models.bert import BertConfig
from vit_exp_tpu_torch.models.convert import from_jax_params
from vit_exp_tpu_torch.models.factory import build_ctclip
from vit_exp_tpu_torch.train import sampler as tsampler
from vit_exp_tpu_torch.train.checkpoint import CheckpointManager
from vit_exp_tpu_torch.train.optimizer import build_optimizer
from vit_exp_tpu_torch.train.trainer import CTClipTrainer

ROOT = Path(__file__).resolve().parents[1]
TINY_ARCH = {"dim": 48, "image_size": 32, "patch_size": 8,
             "temporal_size": 16, "temporal_patch_size": 4,
             "transformer_blocks": 2, "dim_head": 8, "heads": 4,
             "use_flash_attention": True}
TEXT_LEN = 16
LR = 1e-4
STEPS = 3
NOISE = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


class TinyTokenizer:
    """The hash tokenizer's ids folded into the tiny BERT's 128 ids."""
    vocab_size = 128

    def __init__(self):
        self.base = ttokenizer.HashTokenizer()

    def __call__(self, texts, max_length=None):
        out = self.base(texts, max_length=max_length)
        return {"input_ids": out["input_ids"] % self.vocab_size,
                "attention_mask": out["attention_mask"]}


# --- config, tokenizers, data, samplers ---------------------------------------


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.yaml")),
                         ids=lambda p: p.name)
def test_load_config_matches_jax(path):
    assert (dataclasses.asdict(tconfig.load_config(str(path)))
            == dataclasses.asdict(jconfig.load_config(str(path))))


def test_tokenizers_match_jax(tmp_path):
    texts = ["Bilateral pleural effusion, mild cardiomegaly.",
             "Émphysème: 3.5mm nodules (RLL)!", "多 lobe  unaffected\tnoted",
             "x " * 40]
    for tok in (ttokenizer.load_tokenizer(), ttokenizer.HashTokenizer(1200)):
        ref = jtokenizer.HashTokenizer(tok.vocab_size)
        for a, b in zip(tok(texts, max_length=24).values(),
                        ref(texts, max_length=24).values()):
            np.testing.assert_array_equal(a, b)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "bilateral", "pleural", "eff",
         "##usion", ",", "mild", "card", "##io", "##megaly", ".", "3", "5",
         "mm", "nodule", "##s", "(", ")", "!", "emphyseme", ":", "多", "x"])
        + "\n")
    tok = ttokenizer.load_tokenizer(str(vocab))
    assert isinstance(tok, ttokenizer.WordPieceTokenizer)
    ref = jtokenizer.load_tokenizer(str(vocab))
    for a, b in zip(tok(texts, max_length=20).values(),
                    ref(texts, max_length=20).values()):
        np.testing.assert_array_equal(a, b)


def _datasets(n, seed=0):
    tok = TinyTokenizer()
    return (tsynthetic.SyntheticCTDataset(
                n=n, arch=tconfig.ArchConfig(**TINY_ARCH), tokenizer=tok,
                max_text_len=TEXT_LEN, seed=seed),
            jsynthetic.SyntheticCTDataset(
                "imagereport", n=n, arch=jconfig.ArchConfig(**TINY_ARCH),
                tokenizer=tok, max_text_len=TEXT_LEN, seed=seed))


def _assert_same_item(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_synthetic_dataset_matches_jax():
    tds, jds = _datasets(7, seed=3)
    assert len(tds) == len(jds) == 7
    for i in (0, 4, 6):
        _assert_same_item(tds[i], jds[i])
    # the segmentation types are ported (tests/test_torch_seg.py holds
    # their items to JAX's); an unknown type is refused
    with pytest.raises(ValueError):
        tsynthetic.SyntheticCTDataset("imagevideo")


def test_synthetic_batch_drawn_in_place_matches_jax():
    """collate_batch draws the volumes in chunks into one batch array: the
    bytes of JAX's items collated, also with _CHUNK cut to 1,000 values,
    so that a tiny volume spans several chunks and a ragged last one."""
    tds, jds = _datasets(5, seed=4)
    idx = [3, 0, 4]
    ref = jloader.collate([jds[i] for i in idx])
    _assert_same_item(tds.collate_batch(idx), ref)
    chunk = tsynthetic._CHUNK
    tsynthetic._CHUNK = 1000   # several chunks and a ragged last one
    try:
        _assert_same_item(tds.collate_batch(idx), ref)
        _assert_same_item(tds[4], jds[4])
    finally:
        tsynthetic._CHUNK = chunk


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_order_and_bytes_match_jax(drop_last):
    tds, jds = _datasets(7)
    kw = dict(shuffle=True, seed=5, drop_last=drop_last, num_workers=2)
    tl, jl = tloader.Loader(tds, 3, **kw), jloader.Loader(jds, 3, **kw)
    assert len(tl) == len(jl)
    for _ in range(2):   # two epochs: the order is drawn per epoch
        tb, jb = list(tl), list(jl)
        assert len(tb) == len(jb) == len(tl)
        for a, b in zip(tb, jb):
            _assert_same_item(a, b)
    ti, ji = tloader.InfiniteLoader(tl), jloader.InfiniteLoader(jl)
    for _ in range(5):
        _assert_same_item(next(ti), next(ji))


@pytest.mark.parametrize("spec", [
    {"type": "Combined", "acc_steps_list": [2, 0, 1]},
    {"type": "Random", "ratio_list": [0.2, 0.5, 0.3]}], ids=["combined",
                                                            "random"])
def test_samplers_match_jax(spec):
    t = tsampler.build_dataset_sampler(
        tconfig.DatasetSamplerConfig.from_dict(spec), seed=3)
    j = jsampler.build_dataset_sampler(
        jconfig.DatasetSamplerConfig.from_dict(spec), seed=3)
    assert [t.sample(s) for s in range(60)] == [j.sample(s) for s in range(60)]


@pytest.mark.parametrize("k", [1, 2])
def test_accumulation_matches_optax_multisteps(k):
    """4 micro-steps of seeded gradients: the mean of k gradients is
    clipped once and Adam applied to it every k-th micro-step; the
    parameters do not move in between.  The first two gradients have norms
    near max_grad_norm = 0.5 (0.4-0.55) and their mean lies below it; the
    last two are ten times larger and always clipped: Adam is blind to a scale common to all its gradients, so only
    updates clipped by different factors tell a mean from a sum, or one
    clip from two (each such mutation fails this test)."""
    r = np.random.default_rng(50 + k)
    params = {"w": r.standard_normal((6, 5)).astype(np.float32),
              "b": r.standard_normal(5).astype(np.float32)}
    grads = [{n: (r.standard_normal(p.shape) * scale).astype(np.float32)
              for n, p in params.items()} for scale in (0.08, 0.08, 1, 1)]
    cfg = dict(lr=1e-2, wd=0.01, max_grad_norm=0.5,
               gradient_accumulation_steps=k)
    tx = jax_build_optimizer(jconfig.TrainerConfig.from_dict(cfg))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {n: torch.nn.Parameter(torch.from_numpy(p.copy()))
          for n, p in params.items()}
    opt = build_optimizer(tconfig.TrainerConfig.from_dict(cfg), tp.values())
    for i, g in enumerate(grads):
        before = {n: p.detach().clone() for n, p in tp.items()}
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for n, p in tp.items():
            # a copy: the clip scales p.grad in place, and JAX may still be
            # reading g[n] (jnp.asarray shares host memory, dispatch is async)
            p.grad = torch.from_numpy(g[n].copy())
        opt.step()
        for n, p in tp.items():
            assert _rel(p.detach(), jp[n]) < 1e-6, (i, n)
            if (i + 1) % k:
                assert torch.equal(p.detach(), before[n]), (i, n)
    assert opt.grad_norm is not None and float(opt.grad_norm) > 0.5


# --- the slice: CTClipTrainer against the JAX step functions -------------------


def _config_dict(results):
    return {"random_seed": 0, "results_folder": str(results),
            "trainer": {"lr": LR, "wd": 0.01, "max_grad_norm": 0.05,
                        "gradient_accumulation_steps": 2,
                        "num_train_steps": STEPS, "save_model_every": 2},
            "arch": TINY_ARCH,
            "train_data_list": [{"type": "imagereport", "batch_size": 2,
                                 "num_workers": 2}],
            "DatasetSampler": {"type": "Combined", "acc_steps_list": [2]}}


def _port_model(params):
    model = build_ctclip(tconfig.ExperimentConfig(arch=tconfig.ArchConfig(
        **TINY_ARCH)), BertConfig.tiny(), device="cpu", policy=FP32_POLICY,
        dim_latent=DIM_LATENT, attn_impl="pallas")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in from_jax_params(params).items()})
    return model


def _jax_loop(config, params, dataset):
    """trainer.py's train_step loop with JAX's own pieces, on one shard:
    (cl_loss of every micro-step, the parameters after each step, the
    step's metric names)."""
    model = jax_build_ctclip(config, bert_config=JaxBertConfig.tiny(),
                             policy=JAX_FP32, dim_latent=DIM_LATENT,
                             attn_impl="pallas", ff_impl="pallas")
    tx = jax_build_optimizer(config.trainer)
    step_fn = jax_make_train_steps(model, tx, config,
                                   n_data_shards=1)["imagereport"]
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                               tx)
    spec = config.train_data_list[0]
    loader = jloader.InfiniteLoader(jloader.Loader(
        dataset, batch_size=spec["batch_size"], shuffle=True,
        seed=config.random_seed, drop_last=True))
    sampler = jsampler.build_dataset_sampler(config.dataset_sampler,
                                             seed=config.random_seed)
    losses, params, keys = [], [], set()
    for step in range(STEPS):
        for _ in range(sampler.sample(step)[0]):
            batch = next(loader)
            state, metrics = step_fn(state, {
                k: jnp.asarray(batch[k])
                for k in ("image", "input_ids", "attention_mask")}, 1.0)
            losses.append(float(metrics["cl_loss"]))
            keys |= set(metrics)
        params.append(from_jax_params(
            jax.tree_util.tree_map(np.asarray, state.params)))
    return losses, params, keys


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    results = tmp_path_factory.mktemp("slice")
    tconf = tconfig.ExperimentConfig.from_dict(_config_dict(results))
    jconf = jconfig.ExperimentConfig.from_dict(_config_dict(results))
    params = jax_params(jconf, seed=8)
    tds, jds = _datasets(4)
    ref_losses, ref_params, ref_keys = _jax_loop(jconf, params, jds)

    trainer = CTClipTrainer(_port_model(params), tconf, datasets=[tds],
                            use_wandb=False)
    losses, grad_norm, updates = [], {}, []
    step = trainer.steps_by_type["imagereport"]

    def recording(batch, weight):
        metrics = step(batch, weight)
        losses.append(float(metrics["cl_loss"]))
        for n, p in trainer.model.named_parameters():
            grad_norm[n] = max(grad_norm.get(n, 0.0), float(p.grad.norm()))
        if trainer.optimizer.mini_step == 0:   # an update was applied
            updates.append({n: p.detach().numpy().copy()
                            for n, p in trainer.model.named_parameters()})
        return metrics

    trainer.steps_by_type["imagereport"] = recording
    assert trainer.train() == "completed"
    trainer.steps_by_type["imagereport"] = step
    return dict(trainer=trainer, config=tconf, params=params, tds=tds,
                losses=losses, grad_norm=grad_norm, updates=updates,
                ref_losses=ref_losses, ref_params=ref_params,
                ref_keys=ref_keys, results=results)


def test_trainer_matches_jax_steps(slice_run):
    s = slice_run
    assert len(s["losses"]) == len(s["ref_losses"]) == 2 * STEPS
    for got, ref in zip(s["losses"], s["ref_losses"]):
        assert got == pytest.approx(ref, rel=1e-5)
    assert len(s["updates"]) == len(s["ref_params"]) == STEPS
    start = from_jax_params(s["params"])
    for u, (got, ref) in enumerate(zip(s["updates"], s["ref_params"]), 1):
        assert got.keys() == ref.keys()
        for name, p in got.items():
            assert not np.array_equal(p, start[name]), (u, name)
            if s["grad_norm"][name] < NOISE:
                assert np.abs(p - ref[name]).max() <= LR * u, (u, name)
            else:
                assert _rel(p, ref[name]) < 1e-5, (u, name)
    final = {n: p.detach().numpy()
             for n, p in s["trainer"].model.named_parameters()}
    for name, p in final.items():
        np.testing.assert_array_equal(p, s["updates"][-1][name])


def test_metrics_keys_match_jax(slice_run, tmp_path):
    """metrics.jsonl of the port's run against the lines the JAX trainer
    writes for the same run: its step's metrics under the ds{i}_ prefix
    plus its StepTimer's keys, through its MetricLogger
    (vit_exp_tpu/train/trainer.py's train_step and train).  The JAX
    CTClipTrainer itself is not run: it compiles its step for the 8-device
    CPU mesh."""
    from vit_exp_tpu.utils.logging import MetricLogger as JaxLogger
    from vit_exp_tpu.utils.profiling import StepTimer as JaxTimer

    logger, timer = JaxLogger(str(tmp_path), use_wandb=False), JaxTimer()
    for step in range(1, STEPS + 1):
        with timer:
            pass
        logger.log({**{f"ds0_{k}": 1.0 for k in slice_run["ref_keys"]},
                    **timer.metrics()}, step=step)
    logger.close()
    read = lambda p: [set(json.loads(line))   # noqa: E731
                      for line in open(Path(p) / "metrics.jsonl")]
    ref, got = read(tmp_path), read(slice_run["results"])
    assert len(got) == len(ref) == STEPS
    assert got == ref
    assert {"ds0_cl_loss", "ds0_loss", "steps_per_sec_ema"} <= got[-1]


def test_checkpoint_round_trips_bit_exact(slice_run):
    trainer = slice_run["trainer"]
    assert trainer.ckpt.all_steps() == [2, STEPS]
    saved = CheckpointManager(trainer.ckpt.directory).restore(STEPS)
    assert saved["train_state"]["step"] == STEPS
    model_sd = trainer.model.state_dict()
    assert saved["model"].keys() == model_sd.keys()
    for k, v in model_sd.items():
        assert torch.equal(saved["model"][k], v), k
    opt = trainer.optimizer.state_dict()
    got = saved["train_state"]["optimizer"]
    assert got["mini_step"] == opt["mini_step"] == 0
    assert got["schedule"] == opt["schedule"]
    for a, b in zip(got["acc"], opt["acc"]):
        assert torch.equal(a, b)
    assert got["opt"]["param_groups"] == opt["opt"]["param_groups"]
    for i, st in opt["opt"]["state"].items():
        for name, t in st.items():
            assert torch.equal(got["opt"]["state"][i][name], t), (i, name)
    fresh = _port_model(slice_run["params"])
    fresh.load_state_dict(saved["model"], strict=True)


def test_auto_resume_continues_at_the_saved_step(slice_run, tmp_path):
    s = slice_run
    shutil.copytree(Path(s["results"]) / "checkpoints",
                    tmp_path / "checkpoints")
    config = tconfig.ExperimentConfig.from_dict(_config_dict(tmp_path))
    trainer = CTClipTrainer(_port_model(s["params"]), config,
                            datasets=[s["tds"]], resume_step=-1,
                            use_wandb=False)
    assert trainer.step == STEPS
    for (n, a), b in zip(trainer.model.state_dict().items(),
                         s["trainer"].model.state_dict().values()):
        assert torch.equal(a, b), n
    a, b = trainer.optimizer.opt.state_dict(), s["trainer"].optimizer.opt.state_dict()
    for i, st in b["state"].items():
        for name, t in st.items():
            assert torch.equal(a["state"][i][name], t), (i, name)
    assert trainer.train(num_steps=STEPS + 1,
                         profile_dir=str(tmp_path / "trace")) == "completed"
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    lines = open(tmp_path / "metrics.jsonl").readlines()
    assert [json.loads(line)["step"] for line in lines] == [STEPS + 1]
    assert trainer.ckpt.all_steps() == [2, STEPS, STEPS + 1]


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 5):
        ckpt.save(step, {"w": torch.full((3,), float(step))}, {"step": step})
    ckpt.wait_until_finished()
    assert ckpt.all_steps() == [2, 5] and ckpt.latest_step() == 5
    assert torch.equal(ckpt.restore(5)["model"]["w"], torch.full((3,), 5.0))
    assert not list(tmp_path.glob("*.tmp"))


def test_preempted_trainer_saves_and_returns_preempted(slice_run, tmp_path):
    s = slice_run
    config = tconfig.ExperimentConfig.from_dict(_config_dict(tmp_path))
    trainer = CTClipTrainer(_port_model(s["params"]), config,
                            datasets=[s["tds"]], use_wandb=False)
    assert trainer.train(num_steps=1) == "completed"
    previous = signal.getsignal(signal.SIGTERM)
    trainer.install_preemption_handler()
    signal.raise_signal(signal.SIGTERM)
    assert trainer.train(num_steps=STEPS) == "preempted"
    assert trainer.step == 1 and trainer.ckpt.latest_step() == 1
    assert signal.getsignal(signal.SIGTERM) == previous
    resumed = CTClipTrainer(_port_model(s["params"]), config,
                            datasets=[s["tds"]], resume_step=-1,
                            use_wandb=False)
    assert resumed.step == 1


def _tiny_yaml(tmp_path, **trainer):
    cfg = {"random_seed": 0, "results_folder": str(tmp_path / "run"),
           "trainer": {"lr": LR, "wd": 0.01, "num_train_steps": 2,
                       "save_model_every": 0, **trainer},
           "arch": TINY_ARCH, "dim_latent": DIM_LATENT,
           "text_encoder": {"hidden_size": 36, "num_hidden_layers": 2,
                            "num_attention_heads": 3,
                            "intermediate_size": 64,
                            "max_position_embeddings": 128},
           "train_data_list": [{"type": "imagereport", "batch_size": 2,
                                "num_workers": 1}]}
    path = tmp_path / "tiny.yaml"
    path.write_text(json.dumps(cfg))   # JSON is YAML
    return str(path)


def test_run_train_main_on_cpu(tmp_path):
    """The CLI end to end at the tiny arch and BERT-base's vocabulary:
    two steps, then --auto_resume to three."""
    cfg = _tiny_yaml(tmp_path)
    trainer = run_train.main(["--config", cfg, "--synthetic", "4", "--debug"],
                             device="cpu")
    assert trainer.status == "completed" and trainer.step == 2
    attn = trainer.model.visual_transformer.enc_3D.layers[0]._modules["1"]
    assert not attn.static_max   # attn_impl="pallas", the K15 route
    trainer = run_train.main(["--config", cfg, "--synthetic", "4", "--debug",
                              "--auto_resume", "--steps", "3"], device="cpu")
    assert trainer.step == 3 and trainer.ckpt.all_steps() == [2, 3]
    lines = [json.loads(line)
             for line in open(tmp_path / "run" / "metrics.jsonl")]
    assert [d["step"] for d in lines] == [1, 2, 3]
    assert all(math.isfinite(d["ds0_cl_loss"]) for d in lines)


def test_run_train_refuses_what_is_not_ported(tmp_path):
    cfg = _tiny_yaml(tmp_path)
    # an entry over files without its folder raises JAX's KeyError (the
    # folders themselves: tests/test_torch_realdata.py)
    with pytest.raises(KeyError, match="dataset spec needs one of"):
        run_train.main(["--config", cfg], device="cpu")
    # a grid of 2 processes on 1 (model > 1 is ported, M7b)
    with pytest.raises(MeshError, match="1x1x2 != 1"):
        run_train.main(["--config", cfg, "--synthetic", "2", "--mesh",
                        "1,1,2"], device="cpu")
    # the seg hook is ported, but --synthetic brings no segmentation
    # validation set (the JAX CLI skips the name silently)
    hooks = Path(cfg).with_name("hooks.yaml")
    hooks.write_text(json.dumps({**json.loads(Path(cfg).read_text()),
                                 "valid_test_list": ["seg_test"]}))
    with pytest.raises(ValueError, match="seg_test"):
        run_train.main(["--config", str(hooks), "--synthetic", "2"],
                       device="cpu")
    with pytest.raises(SystemExit):
        run_train.parse_args(["--config", cfg, "--attn_impl", "xla"])
