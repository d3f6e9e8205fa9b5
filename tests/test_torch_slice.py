"""The PyTorch port's zero-shot serving slice, end to end, on the CPU.

- Parity: ``ZeroShotClassifier.predict_batch`` of the port against the JAX
  engine built as tests/test_int8_parity.py builds it, in the bf16 serving
  configuration (attn_impl="pallas_static", ff_impl="pallas", fuse_qkv=True,
  Pallas in interpret mode), on the same perturbed parameters, prompts and
  volumes.  Under FP32_POLICY the tolerance is 1e-5 absolute on the
  probabilities: fp32 on both sides, only the summation order differs.
  Under the bf16 policy both sides round at the same points, but a bf16
  rounding can flip where sums are ordered differently; the tolerance is
  the 0.02 probability bound the JAX package holds its own precision
  changes to (measured difference 3.5e-3).
- Guards: the port imports neither JAX, flax nor the JAX package, serving
  (bf16 and int8), taking a train step or training through
  ``run_train.main`` at attn_impl="pallas" with a checkpoint and a resume
  (checked in a subprocess, since this process has JAX loaded);
  ``chip_smoke.py`` fails, printing no "ok" line, without a GPU and without
  the rest of the repo.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from __graft_entry__ import _flagship_config
from tests.test_torch_models import (DIM_LATENT, jax_params, jax_serving_model,
                                     port_model)
from vit_exp_tpu.eval import zero_shot as jzs
from vit_exp_tpu_torch.eval import zero_shot as tzs

ROOT = Path(__file__).resolve().parents[1]
PATHS = ["Lung nodule", "Pleural effusion", "Emphysema"]
TEXT_LEN = 12


def _tokenizer(seed=0):
    """Deterministic ids below the tiny vocab, with padded prompts."""
    def tokenize(prompts, max_length):
        r = np.random.default_rng(seed)
        ids = r.integers(1, 128, (len(prompts), max_length)).astype(np.int32)
        mask = np.ones_like(ids)
        for i in range(len(prompts)):
            mask[i, 4 + i % (max_length - 4):] = 0
        return {"input_ids": ids, "attention_mask": mask}
    return tokenize


def test_prompts_match():
    assert tzs.PATHOLOGIES == jzs.PATHOLOGIES
    assert tzs.build_pathology_prompts() == jzs.build_pathology_prompts()


@pytest.mark.parametrize("policy,atol", [("fp32", 1e-5), ("bf16", 0.02)])
def test_zero_shot_probs_match_jax_engine(policy, atol):
    config = _flagship_config(tiny=True)
    params = jax_params(config, seed=3)
    a = config.arch
    vols = np.random.default_rng(4).uniform(
        -1, 1, (2, 1, a.temporal_size, a.image_size, a.image_size)
    ).astype(np.float32)

    ref = jzs.ZeroShotClassifier(
        jax_serving_model(config, policy), params, _tokenizer(),
        pathologies=PATHS, max_text_len=TEXT_LEN, batch_size=2
    ).predict_batch(vols)
    eng = tzs.ZeroShotClassifier(port_model(config, params, policy),
                                 _tokenizer(), pathologies=PATHS,
                                 max_text_len=TEXT_LEN)
    assert eng.prepare().shape == (2 * len(PATHS), DIM_LATENT)
    out = eng.predict_batch(vols)
    assert out.shape == ref.shape == (2, len(PATHS))
    np.testing.assert_allclose(out, ref, atol=atol)


_GUARD = """
import json, os, sys, tempfile, types
import numpy as np
import torch
from vit_exp_tpu_torch.eval.zero_shot import ZeroShotClassifier
from vit_exp_tpu_torch.models.bert import BertConfig
from vit_exp_tpu_torch.models.factory import build_ctclip
from vit_exp_tpu_torch.ops import _build, attention, flash_attention, fused_proj
from vit_exp_tpu_torch.ops import geglu_ff, patches, posemb
from vit_exp_tpu_torch.models import convert, ctclip, ctvit3d, layers, losses
from vit_exp_tpu_torch.train import checkpoint, optimizer, sampler, steps
from vit_exp_tpu_torch.train import trainer
from vit_exp_tpu_torch.core import config, precision
from vit_exp_tpu_torch.data import loader, synthetic, tokenizer
from vit_exp_tpu_torch.utils import logging, profiling
from vit_exp_tpu_torch.cli import run_train
arch = types.SimpleNamespace(dim=48, image_size=32, patch_size=8,
    temporal_size=16, temporal_patch_size=4, transformer_blocks=2,
    dim_head=8, heads=4, channels=1, use_flash_attention=True)
def tok(prompts, max_length):
    ids = np.ones((len(prompts), max_length), np.int64)
    return {"input_ids": ids, "attention_mask": np.ones_like(ids)}
probs = [ZeroShotClassifier(build_ctclip(
    arch, BertConfig.tiny(), device="cpu", dim_latent=16, fuse_qkv=True,
    int8=int8), tok, max_text_len=8).predict_batch(
        torch.randn(2, 1, 16, 32, 32)) for int8 in (False, True)]
model = build_ctclip(arch, BertConfig.tiny(), device="cpu",
                     dim_latent=16).train()
opt = optimizer.build_optimizer(types.SimpleNamespace(
    lr=1e-3, wd=0.0, max_grad_norm=0.5, warmup_steps=0,
    gradient_accumulation_steps=1), model.parameters())
step = steps.make_train_steps(model, opt, types.SimpleNamespace())
loss = float(step["imagereport"]({"image": torch.randn(2, 1, 16, 32, 32),
    "input_ids": torch.ones(2, 8, dtype=torch.long)}, 1.0)["loss"])
tmp = tempfile.mkdtemp()
cfg = os.path.join(tmp, "tiny.yaml")
with open(cfg, "w") as f:
    json.dump({"results_folder": os.path.join(tmp, "run"),
               "trainer": {"num_train_steps": 2},
               "arch": dict(vars(arch), arch_name="ctvit_3d"),
               "dim_latent": 16,
               "text_encoder": {"hidden_size": 36, "num_hidden_layers": 1,
                                "num_attention_heads": 3,
                                "intermediate_size": 32,
                                "max_position_embeddings": 128},
               "train_data_list": [{"batch_size": 2, "num_workers": 1}]}, f)
argv = ["--config", cfg, "--synthetic", "2", "--debug", "--attn_impl",
        "pallas"]
run = run_train.main(argv, device="cpu")
run = run_train.main(argv + ["--auto_resume", "--steps", "3"], device="cpu")
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "vit_exp_tpu", "triton"))
print(json.dumps({"shape": [list(p.shape) for p in probs],
                  "finite": bool(np.isfinite(probs).all() and np.isfinite(loss)),
                  "run_train": [run.status, run.step, run.ckpt.all_steps()],
                  "bad": bad}))
"""


def test_port_runs_without_jax_flax_or_the_jax_package():
    res = subprocess.run([sys.executable, "-c", _GUARD], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"shape": [[2, 18], [2, 18]], "finite": True,
                   "run_train": ["completed", 3, [2, 3]], "bad": []}


_INGEST_GUARD = """
import base64, gzip, io, json, os, struct, sys, tempfile, threading
import urllib.request
import numpy as np
from vit_exp_tpu_torch import native
from vit_exp_tpu_torch.cli import (pack_dataset, preprocess_ctrate,
                                   run_zero_shot_cls, run_zero_shot_seg, serve)
from vit_exp_tpu_torch.data import datasets, nifti, packed, preprocess_host
from vit_exp_tpu_torch.eval import metrics, sweep
from vit_exp_tpu_torch.ops import preprocess
from vit_exp_tpu_torch.train.checkpoint import load_model_weights
tmp = tempfile.mkdtemp()
cfg = os.path.join(tmp, "tiny.yaml")
with open(cfg, "w") as f:
    json.dump({"arch": {"dim": 48, "image_size": 32, "patch_size": 8,
                        "temporal_size": 16, "temporal_patch_size": 4,
                        "transformer_blocks": 2, "dim_head": 8, "heads": 4},
               "dim_latent": 16,
               "text_encoder": {"hidden_size": 36, "num_hidden_layers": 1,
                                "num_attention_heads": 3,
                                "intermediate_size": 32,
                                "max_position_embeddings": 512}}, f)
# a NIfTI file through the preprocessing CLI's host path
src = os.path.join(tmp, "nii")
os.makedirs(src)
hdr = bytearray(352)
struct.pack_into("<i", hdr, 0, 348)
struct.pack_into("<8h", hdr, 40, 3, 10, 12, 6, 1, 1, 1, 1)
struct.pack_into("<h", hdr, 70, 4)
struct.pack_into("<8f", hdr, 76, 1, 0.75, 0.75, 1.5, 1, 1, 1, 1)
struct.pack_into("<f", hdr, 108, 352.0)
vol = np.arange(720, dtype=np.int16).reshape(10, 12, 6)
with gzip.open(os.path.join(src, "valid_1_a_1.nii.gz"), "wb") as f:
    f.write(bytes(hdr) + vol.tobytes(order="F"))
with open(os.path.join(tmp, "meta.csv"), "w") as f:
    f.write('VolumeName,RescaleSlope,RescaleIntercept,XYSpacing,ZSpacing\\n'
            'valid_1_a_1.nii.gz,1,-300,"[0.6, 0.6]",1.0\\n')
preprocess_ctrate.main(["--src", src, "--metadata",
                        os.path.join(tmp, "meta.csv"), "--out",
                        os.path.join(tmp, "tree"), "--workers", "1",
                        "--split", "valid"])
npz = np.load(os.path.join(tmp, "tree", "valid_1", "valid_1a",
                           "valid_1_a_1.npz"))["arr_0"]
# a packed store and its labels, scored by the CLI at int8 and bf16
names = [f"v{i}.nii.gz" for i in range(3)]
r = np.random.default_rng(0)
with packed.PackedShardWriter(os.path.join(tmp, "store")) as w:
    for n in names:
        w.append(n, r.uniform(0, 1, (1, 16, 32, 32)).astype(np.float16),
                 meta={"text": "report"})
labels = os.path.join(tmp, "labels.csv")
with open(labels, "w") as f:
    f.write("VolumeName," + ",".join(f"p{c}" for c in range(18)) + "\\n"
            + "".join(n + "," + ",".join(str((i + c) % 2) for c in range(18))
                      + "\\n" for i, n in enumerate(names)))
base = ["--config", cfg, "--packed_root", os.path.join(tmp, "store"),
        "--labels_csv", labels, "--batch_size", "2"]
res = [run_zero_shot_cls.main(base + ["--results_folder",
                                      os.path.join(tmp, m), m],
                              device="cpu")["random_init"]
       for m in ("--int8", "--no-int8")]
# the server, int8, one classify and one embed
args = serve.parse_args(["--config", cfg])
engine, latent_fn, shape, channels = serve.build_service(args, "cpu")
srv = serve.build_server(engine, latent_fn, shape, 0)
t = threading.Thread(target=srv.serve_forever, daemon=True)
t.start()
buf = io.BytesIO()
np.save(buf, r.uniform(0, 1, shape).astype(np.float32))
body = json.dumps({"volume": base64.b64encode(buf.getvalue()).decode()})
codes = []
for path in ("/classify", "/embed"):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}"
                                 + path, data=body.encode())
    with urllib.request.urlopen(req) as resp:
        codes.append(resp.status)
srv.shutdown()
srv.server_close()
srv.batcher.close()
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "vit_exp_tpu", "triton", "pandas",
              "sklearn"))
print(json.dumps({"npz": list(npz.shape), "native": native.available(),
                  "finite": [bool(np.isfinite(x["mean_auc"])) for x in res],
                  "codes": codes, "bad": bad}))
"""


def test_ingest_and_serving_run_without_jax_pandas_or_sklearn():
    """Every module of the ingest and serving slice imports, a NIfTI file is
    preprocessed, run_zero_shot_cls scores a packed store (int8 and bf16)
    and the server answers a classify and an embed, on the CPU, with no
    jax, flax, pandas, sklearn or JAX package module loaded."""
    res = subprocess.run([sys.executable, "-c", _INGEST_GUARD], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"npz": [4, 8, 9], "native": True, "finite": [True, True],
                   "codes": [200, 200], "bad": []}


_GENERATIVE_GUARD = """
import json, sys, tempfile
import numpy as np
import torch
from vit_exp_tpu_torch.cli import run_ctvit_recon, run_maskgit_sample
from vit_exp_tpu_torch.data import bpe, video
from vit_exp_tpu_torch.models import (ctvit, fallback, gan, maskgit,
                                      maskgit_pipeline, t5_adapter, vgg, vq)
from vit_exp_tpu_torch.models.factory import init_parameters_
from vit_exp_tpu_torch.train.ctvit_trainer import CTViTTrainer
model = ctvit.CTViT(dim=16, codebook_size=32, image_size=8, patch_size=4,
                    temporal_patch_size=2, spatial_depth=1, temporal_depth=1,
                    dim_head=4, heads=2, device="cpu")
init_parameters_(model, 0)
trainer = CTViTTrainer(model, results_folder=tempfile.mkdtemp(),
                       sample_every=0)
logs = trainer.train_step(torch.rand(1, 1, 5, 8, 8))
mg = maskgit.MaskGit(32, 12, 16, depth=1, heads=2, dim_head=4,
                     dim_context=16, device="cpu")
init_parameters_(mg, 1)
with torch.no_grad():
    ids = maskgit.maskgit_sample(mg, batch=1, seq_len=12, steps=2,
                                 context=torch.randn(1, 3, 16),
                                 context_mask=torch.ones(1, 3),
                                 generator=torch.Generator().manual_seed(0))
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "vit_exp_tpu", "triton", "pandas"))
print(json.dumps({"finite": bool(np.isfinite(list(logs.values())).all()),
                  "perceptual": logs["perceptual_loss"] > 0,
                  "ids": [int(ids.min()) >= 0, int(ids.max()) < 32],
                  "bad": bad}))
"""


def test_generative_stack_runs_without_jax_or_pandas():
    """Every module of the legacy generative stack imports, one tiny
    CTViTTrainer step (the random VGG perceptual term on) and one
    maskgit_sample run, with no jax, flax, pandas or JAX package module
    loaded."""
    res = subprocess.run([sys.executable, "-c", _GENERATIVE_GUARD], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"finite": True, "perceptual": True, "ids": [True, True],
                   "bad": []}


def _no_ok_line(stdout: str) -> bool:
    return '"ok": true' not in stdout and '"ok":true' not in stdout


def test_chip_smoke_fails_without_a_gpu():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert _no_ok_line(res.stdout)


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert _no_ok_line(res.stdout)


def test_chip_smoke_pair_line_and_determinism_check():
    """The pair's line sums dK/dV and dQ and divides by the one SDPA time
    of each input set; the determinism check compares every gradient."""
    import torch

    import chip_smoke as cs

    def rows(kv_ms, dq_ms, sdpa_ms):
        return [dict(counter="K1", ms=9.0, library_ms=1.0),
                dict(counter="dKdV", ms=kv_ms, library_ms=sdpa_ms),
                dict(counter="dQ", ms=dq_ms, library_ms=sdpa_ms)]

    line = cs.pair_line({"train": rows(5.0, 3.0, 8.0),
                         "online": rows(6.0, 4.0, 5.0)}, "card")
    assert ("real kv dK/dV 5.000 + dQ 3.000 = 8.000 ms against SDPA's "
            "backward 8.000 ms, factor 1.000") in line
    assert "concatenated kv dK/dV 6.000 + dQ 4.000 = 10.000 ms" in line
    assert "factor 2.000" in line and line.endswith("on card")
    from vit_exp_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn(1, 2, n, 32, generator=g)
                     for n in (9, 7, 7, 9))
    lse, delta = torch.randn(1, 2, 9, generator=g), torch.randn(1, 2, 9)
    bwd = (q, k, v, dout, lse, delta, 0.2)
    cs.same_bits_twice(lambda: (*fa.attention_bwd_dkv(*bwd),
                                fa.attention_bwd_dq(*bwd)), "the pair")


def test_chip_smoke_forward_lines_and_bound():
    """Each forward's line divides its time by SDPA's from the same row;
    the bound is the largest of the tensor-core, exp-unit and bytes times;
    the bitwise check passes on equal runs and fails on unequal ones."""
    import torch

    import chip_smoke as cs

    rows = {"serve": [dict(name="K1 a", counter="K1", ms=6.0, library_ms=3.0,
                           bound_ms=1.5)],
            "train": [dict(name="K1 b", counter="K1", ms=4.5, library_ms=3.0,
                           bound_ms=1.5),
                      dict(name="dQ", counter="dQ", ms=1.0, library_ms=9.0,
                           bound_ms=1.5)],
            "online": [dict(name="K15 c", counter="K15", ms=3.0,
                            library_ms=4.0, bound_ms=1.5)]}
    k1, k15 = cs.forward_lines(rows, "card")
    assert k1.startswith("attention forward K1: K1 a 6.000 ms against "
                         "SDPA's forward 3.000 ms, factor 2.000")
    assert "K1 b 4.500 ms" in k1 and "factor 1.500" in k1
    assert "dQ" not in k1 and k1.endswith("on card")
    assert "K15 c 3.000 ms" in k15 and "factor 0.750" in k15
    # 2·10^12 logits: 1 ms of exps at 2·10^15 exps/s, 0.5 ms of products
    ops = {"bf16": 989e9 / 2, "exp": 2e12}
    ms, by, pipe = cs.bound(ops, 0, 2e15)
    assert (by, pipe) == ("operations", "exp") and ms == pytest.approx(1.0)
    ms, by, pipe = cs.bound(ops, 0, 2e16)
    assert (by, pipe) == ("operations", "ops") and ms == pytest.approx(0.5)
    ms, by, pipe = cs.bound(ops, 3.35e10, 2e16)
    assert (by, pipe) == ("bytes", "bytes") and ms == pytest.approx(10.0)
    t = torch.arange(4.0)
    cs.same_bits_twice(lambda: (t, t + 1), "equal runs")
    flips = iter([0.0, 1.0])
    with pytest.raises(RuntimeError, match="not bit-reproducible"):
        cs.same_bits_twice(lambda: (t + next(flips),), "unequal runs")


def test_chip_smoke_gradient_errors_hold_at_tiny_norms():
    """The cosine of gradients with norms far below 1e-8 is still exact
    (cosine_similarity's eps would drive it towards 0)."""
    import torch

    import chip_smoke as cs

    a = torch.randn(64, generator=torch.Generator().manual_seed(0)) * 1e-11
    b = a.clone()
    b[0] += 1e-13
    rel, cos = cs.grad_errors(a, b)
    assert rel == pytest.approx(1e-13 / float(b.double().norm()), rel=1e-3)
    assert cos == pytest.approx(1.0, abs=1e-6)
    assert cs.grad_errors(a, -a) == pytest.approx((2.0, -1.0))


ATTENTION_COUNTERS = ("K1", "dKdV", "dQ", "K9/K10", "K15")


def test_chip_smoke_phases_rehearse_on_cpu(tmp_path):
    """chip_smoke's kernel cases, engines, train-step comparisons and
    run_train phase at a tiny size on the CPU (where every wrapper runs its
    plain twin): each case names a real source and the `def` line of the
    TPU kernel it replaces, carries the work its bound is computed from,
    and every launch counter has its own row; the kernel-path engines (bf16
    and int8) agree with the all-plain engines on the same weights; the
    int8 accuracy check runs; the two train steps agree at both attention
    kernels; run_train trains, saves and resumes bit for bit."""
    import torch

    import chip_smoke as cs
    from vit_exp_tpu_torch.models.bert import BertConfig

    cpu = torch.device("cpu")
    arch = dict(dim=48, image_size=32, patch_size=8, temporal_size=16,
                temporal_patch_size=4, transformer_blocks=2, dim_head=32,
                heads=2, channels=1, use_flash_attention=True)
    cases = (cs.kernel_cases(cpu, arch, batch=1)
             + cs.training_kernel_cases(cpu, arch, batch=1)
             + cs.int8_kernel_cases(cpu, arch, batch=1)
             + cs.online_kernel_cases(cpu, arch, batch=1))
    assert [c.counter for c in cases].count("K1") == 2
    assert [c.counter for c in cases].count("K15") == 2
    assert {c.counter for c in cases} == set(cs.kernel_counters())
    for c in cases:
        assert c.route == "cuda" and (ROOT / c.source).is_file()
        path, line = c.replaces.split(":")
        assert (ROOT / path).read_text().splitlines()[int(line) - 1].startswith(
            "def _"), c.replaces
        out, ref = c.kern(), c.plain()
        outs = out if isinstance(out, tuple) else (out,)
        for a, b in zip(outs, ref if isinstance(ref, tuple) else (ref,)):
            assert cs.compare(a, b)[:2] == (0.0, 0.0), c.name
        # an H100 SXM's exp rate at its 1,980 MHz clocks.max.sm
        ms, by, pipe = cs.bound(c.ops, c.in_bytes + cs.nbytes(*outs),
                                cs.EXP_PER_SM_CLOCK * 132 * 1.98e9)
        assert ms > 0 and by in ("bytes", "operations"), c.name
        assert (by == "bytes") == (pipe == "bytes"), c.name
        assert ("exp" in c.ops) == (c.counter in ATTENTION_COUNTERS), c.name
        assert (c.library is not None) == (c.counter in (
            "K1", "dKdV", "dQ", "K15", "K8dh", "K8dy", "K8w", "K2h", "K2o",
            "K3", "K4", "K11h", "K11o", "K13mm", "K14"))
    for attn_impl in ("pallas_static", "pallas"):
        res, launches, kern, batch = cs.compare_train_steps(
            cpu, arch, BertConfig.tiny(), 2, TEXT_LEN, attn_impl=attn_impl)
        assert res["loss_kernel"] == res["loss_plain"] and res["finite"]
        assert res["norm_kernel"] == res["norm_plain"] > 0
        assert not res["missing"] and len(res["tower"]) > 10
        assert all(e == 0.0 and c == pytest.approx(1.0)
                   for e, c in res["tower"].values())
        assert launches == cs.expected_launches({})
        assert np.isfinite(float(kern[2](batch, 1.0)["loss"]))
    tiny = {"arch": arch, "dim_latent": 16,
            "text_encoder": {"hidden_size": 36, "num_hidden_layers": 1,
                             "num_attention_heads": 3, "intermediate_size": 32,
                             "max_position_embeddings": 128}}
    rt, tt = cs.run_train_phase(cpu, tmp_path, tiny, synthetic=4,
                                throughput_samples=8, throughput_steps=3,
                                skip=1)
    assert len(rt["losses"]) == 3 and len(rt["times"]) == 3
    assert rt["ckpt_gb"] > 0 and rt["sps"] > 0 and rt["wait_s"] >= 0
    assert rt["window"] == (2, 2) and len(rt["waits"]) == 1
    assert rt["launches"] == cs.expected_launches({})
    assert tt.step == 3 and tt.status == "completed"
    vol = torch.randn(1, 1, 16, 32, 32)
    engines = {}
    for int8 in (False, True):
        eng = cs.build_engine(cpu, arch, BertConfig.tiny(), TEXT_LEN,
                              int8=int8)
        ref = cs.build_engine(cpu, arch, BertConfig.tiny(), TEXT_LEN,
                              int8=int8, use_kernels=False,
                              state_dict=eng.model.state_dict())
        np.testing.assert_allclose(eng.predict_batch(vol),
                                   ref.predict_batch(vol), atol=1e-6)
        engines[int8] = eng
    engines[True].model.load_state_dict(engines[False].model.state_dict())
    acc = cs.int8_accuracy(engines[True], engines[False],
                           vol.expand(2, -1, -1, -1, -1), 2)
    assert acc["volumes"] == 4 and acc["finite"]
    assert 0 < acc["dmax"] < cs.INT8_PROB_TOL
    assert 0 <= acc["auroc_min"] <= 1 and -1 <= acc["tau_min"] <= 1


def test_chip_smoke_generative_phase_rehearses_on_cpu():
    """chip_smoke's generative phase at a tiny size on the CPU: the trainer's
    steps and their discriminator schedule, the fp32 comparison (CPU
    against CPU here), MaskGIT's step and sample on a tiny BERT's states,
    and run_ctvit_recon on one synthetic volume."""
    import torch

    import chip_smoke as cs
    from vit_exp_tpu_torch.models.bert import BertConfig

    ctvit = dict(dim=16, codebook_size=32, image_size=8, patch_size=4,
                 temporal_patch_size=2, spatial_depth=1, temporal_depth=1,
                 dim_head=4, heads=2)
    r = cs.generative_phase(
        torch.device("cpu"), "cpu", BertConfig.tiny(), ctvit_kw=ctvit,
        maskgit_kw=dict(dim=16, depth=1, heads=2, dim_head=4), frames=7,
        steps=3, check_frames=5, sample_steps=3, text_len=12,
        recon_argv=["--dim", "16", "--image_size", "8", "--patch_size", "4",
                    "--num_frames", "5"])
    assert [("discr_loss" in lg) for lg in r["logs"]] == [False, False, True]
    assert r["enc_rel"] == r["dec_rel"] == 0.0 and r["agree"] == r["n_idx"]
    assert np.isfinite(r["mg_loss"]) and r["recon_shape"] == (8, 8, 5)
    assert len(cs.generative_lines(r, "cpu")) == 3 + 3


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119geglu_bwd_dh_kernelEPK13__nv_bfloat16ii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119geglu_bwd_dh_kernelEPK13__nv_bfloat16ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 464 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112wgrad_kernelEPKfii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112wgrad_kernelEPKfii
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_Z9other_kernelv' for 'sm_90a'
ptxas info    : Used 20 registers, 352 bytes cmem[0]
"""


def test_chip_smoke_ptxas_report():
    """The build log's registers and spills per named kernel; an entry
    without a spill line counts none."""
    import chip_smoke as cs

    rep = cs.ptxas_report(PTXAS_LOG, ("geglu_bwd_dh_kernel", "wgrad_kernel",
                                      "other_kernel", "missing_kernel"))
    assert rep == {"geglu_bwd_dh_kernel": (168, 0, 0),
                   "wgrad_kernel": (128, 12, 16), "other_kernel": (20, 0, 0)}


def test_chip_smoke_ptxas_report_takes_the_worst_template_instance():
    """A kernel template compiled at several instances reports the largest
    registers and spills over them, so a spill in any instance shows."""
    import chip_smoke as cs

    log = "\n".join(
        f"ptxas info    : Compiling entry function "
        f"'_ZN12_GLOBAL__N_120ln_qkv_int8_x_kernelILi{n}EEEvPKii' for "
        f"'sm_90a'\n    0 bytes stack frame, {st} bytes spill stores, "
        f"{ld} bytes spill loads\nptxas info    : Used {regs} registers"
        for n, regs, st, ld in ((1, 30, 0, 0), (8, 56, 8, 4), (3, 40, 0, 0)))
    assert cs.ptxas_report(log, ("ln_qkv_int8_x_kernel",)) == {
        "ln_qkv_int8_x_kernel": (56, 8, 4)}


def test_chip_smoke_rank_statistics():
    """The accuracy check's AUROC and Kendall τ on hand-checked cases."""
    import chip_smoke as cs

    labels = np.array([0, 0, 1, 1])
    assert cs.rank_auroc(np.array([0.1, 0.2, 0.3, 0.4]), labels) == 1.0
    assert cs.rank_auroc(np.array([0.4, 0.3, 0.2, 0.1]), labels) == 0.0
    assert cs.rank_auroc(np.array([0.1, 0.3, 0.3, 0.4]), labels) == 0.875
    a = np.array([1.0, 2.0, 3.0, 4.0])
    assert cs.kendall_tau(a, a) == 1.0 and cs.kendall_tau(a, -a) == -1.0


def test_chip_smoke_widths_rows_take_each_path_launches():
    """Phase "widths"' JSON rows: the tiny widths' rows take the launches
    of the tiny configs' run_train step and run_zero_shot_cls calls, the
    head-dim 16 rows those of the same paths together, the head-dim 64
    rows none; a row whose kernel its path never launched fails."""
    import chip_smoke as cs

    def rows(*counters):
        return [{"name": f"row {c}", "counter": c, "ms": 1.0} for c in counters]

    attention = ("K1", "K15", "dKdV", "dQ", "K9/K10")
    table = {"tiny_train": rows("K15", "dKdV", "dQ", "K2x", "K4", "K8w"),
             "tiny_serve_bf16": rows("K1", "K2x", "K3", "K4"),
             "tiny_serve_int8": rows("K9/K10", "K11y", "K13x", "K14", "K4"),
             "head16": rows(*attention), "head64": rows(*attention)}
    blocks = 2
    bf16 = cs.expected_launches({"K4": 1, **{k: blocks for k in (
        "K1", "K2x", "K2h", "K2o", "K3")}})
    int8 = cs.expected_launches({"K4": 1, **{k: blocks for k in (
        "K9/K10", "K11y", "K11h", "K11q", "K11o", "K13x", "K13mm", "K14")}})
    widths = {"tiny": {"rt_launches": cs.train_launches(blocks),
                       "serve": {"int8": {"launches": int8},
                                 "bf16": {"launches": bf16}}}}
    out = cs.widths_kernel_rows(table, widths)
    assert len(out) == sum(len(r) for r in table.values())
    assert all("counter" not in r for r in out)
    head64 = [r for r in out if "head dim 64" in r["name"]]
    assert len(head64) == 5 and all(r["launches"] == 0 for r in head64)
    others = [r for r in out if r not in head64]
    assert all(r["launches"] > 0 and "widths tiny" in r["name"]
               for r in others)
    assert {r["launches"] for r in others if r["name"].startswith(
        "row K8w")} == {2 * blocks}
    widths["tiny"]["rt_launches"] = cs.expected_launches({})
    with pytest.raises(RuntimeError, match="never launched"):
        cs.widths_kernel_rows(table, widths)
