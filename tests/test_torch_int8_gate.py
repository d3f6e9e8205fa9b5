"""CPU checks of the port's int8 accuracy gate (vit_exp_tpu_torch/eval/
int8_gate.py, run by scripts/int8_accuracy_gate_torch.py and by
chip_smoke.py's int8 phase).

- ``rank_auroc`` (the Mann-Whitney U with ties averaged: the card's host
  has no sklearn) against a brute-force count over every (positive,
  negative) pair, a tie counting one half, on data with many ties.
- ``kendall_tau`` against the JAX script's own ``kendall_tau``.
- ``verdict`` fails on either bound and on a gate with no label spread;
  ``gate_verdict`` fails when any base fails, naming the base.
- The int8 tower moves its tokens off the bf16 tower's by as much as JAX's
  int8 tower does at the bf16 policy, on the same weights and volumes
  (the size of the gate's noise is quantization's, not the port's own).
- The gate's statistics are JAX's: at the tiny heads-packed arch, on JAX's
  own seeded init and the gate's 200 volumes, the port's int8 engine sits
  off its bf16 engine by JAX's mean |Δprob|, Kendall τ and rank AUROC.
- The script at ``--device cpu --volumes 8`` (the JAX script's CPU arch on
  the plain route) prints the statistics of each base and its verdict, and
  its exit code follows the verdict; with ``--witnesses`` it also prints
  the plain engines' readings on each base.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from vit_exp_tpu_torch.eval import int8_gate

ROOT = Path(__file__).resolve().parents[1]


def _pairwise_auroc(scores, labels):
    pos, neg = scores[labels == 1], scores[labels == 0]
    diff = pos[:, None] - neg[None, :]
    return float(((diff > 0) + 0.5 * (diff == 0)).mean())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_auroc_is_the_pairwise_count_with_ties(seed):
    r = np.random.default_rng(seed)
    scores = r.integers(0, 6, 60).astype(np.float64) / 5   # many ties
    labels = (r.uniform(size=60) < 0.4).astype(int)
    assert int8_gate.rank_auroc(scores, labels) == pytest.approx(
        _pairwise_auroc(scores, labels), abs=1e-12)
    labels = np.array([0, 0, 1, 1])
    assert int8_gate.rank_auroc(np.array([0.1, 0.3, 0.3, 0.4]), labels) \
        == 0.875


def test_kendall_tau_is_the_jax_scripts():
    spec = importlib.util.spec_from_file_location(
        "int8_accuracy_gate", ROOT / "scripts" / "int8_accuracy_gate.py")
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    r = np.random.default_rng(3)
    a = r.standard_normal(50)
    b = a + 0.5 * r.standard_normal(50)
    b[::7] = b[0]   # ties
    assert int8_gate.kendall_tau(a, b) == jax_script.kendall_tau(a, b)


def test_verdict_holds_both_bounds():
    ok = dict(finite=True, labels=18, dmax=0.01, auroc_min=0.999)
    assert int8_gate.verdict(ok) == []
    assert len(int8_gate.verdict(dict(ok, dmax=0.03))) == 1
    assert len(int8_gate.verdict(dict(ok, auroc_min=0.99))) == 1
    assert len(int8_gate.verdict(dict(ok, labels=0,
                                      auroc_min=float("nan")))) == 1
    assert int8_gate.verdict(dict(ok, dmax=float("nan")))
    fails = int8_gate.gate_verdict({1: dict(ok, auroc_min=0.99), 2: ok})
    assert len(fails) == 1 and fails[0].startswith("base 1: min rank AUROC")
    assert int8_gate.gate_verdict({1: ok, 2: ok}) == []


def test_gate_bases_are_distinct_draws_and_the_first_is_the_serving_one():
    """The gate's one base is chip_smoke.py's serving volumes' draw (the
    base of its earlier 16-volume check); each witness seed draws another
    base."""
    import torch

    arch = int8_gate.CPU_ARCH
    assert int8_gate.GATE_BASE_SEEDS == (1,)
    bases = [int8_gate.gate_base("cpu", arch, s, 2)
             for s in int8_gate.GATE_BASE_SEEDS
             + int8_gate.WITNESS_BASE_SEEDS]
    g = torch.Generator(device="cpu").manual_seed(1)
    serving = torch.randn((2, 1, arch["temporal_size"], arch["image_size"],
                           arch["image_size"]), generator=g).to(
                               torch.bfloat16)
    assert torch.equal(bases[0], serving)
    assert all(not torch.equal(a, b) for i, a in enumerate(bases)
               for b in bases[i + 1:])


def test_int8_tower_noise_is_jaxs_at_the_bf16_policy():
    """At the heads-packed tiny arch (the production route K13 → K10 → K14
    → K11) under the bf16 policy, JAX's towers jitted as its engine runs
    them: the int8 tower's tokens sit off the bf16 tower's at JAX's
    relative L2 within 5% (measured 2.2%; eagerly the two agree to 0.1%).
    XLA's fusions skip some bf16 roundings that eager JAX and the port
    keep, and the int8 codes amplify them: the port's int8 tokens sit off
    jitted JAX's by 0.57 of the noise, an independent draw of the same
    size, so only the size is compared.  tests/test_torch_int8.py holds the
    int8 route itself to JAX's at the fp32 policy."""
    import jax
    import jax.numpy as jnp
    import torch

    from tests.test_torch_int8 import _config
    from tests.test_torch_models import (DIM_LATENT, POLICIES, jax_params,
                                         port_model)
    from vit_exp_tpu.models.bert import BertConfig as JaxBertConfig
    from vit_exp_tpu.models.ctclip import CTCLIP as JaxCTCLIP
    from vit_exp_tpu.models.factory import build_ctclip as jax_build_ctclip

    config = _config("heads_packed")
    a = config.arch
    params = jax_params(config, seed=5)
    vols = np.random.default_rng(40).uniform(
        -1, 1, (2, 1, a.temporal_size, a.image_size, a.image_size))

    def jax_tokens(int8):
        model = jax_build_ctclip(
            config, bert_config=JaxBertConfig.tiny(),
            policy=POLICIES["bf16"][0], dim_latent=DIM_LATENT,
            attn_impl="pallas_static_int8" if int8 else "pallas_static",
            ff_impl="pallas_int8" if int8 else "pallas", fuse_qkv=True)
        tokens = jax.jit(lambda p, v: model.apply(
            {"params": p}, v, method=JaxCTCLIP.encode_image_tokens))
        return np.asarray(tokens(params, jnp.asarray(vols, jnp.bfloat16)),
                          np.float32)

    def port_tokens(int8):
        model = port_model(config, params, policy="bf16", int8=int8)
        with torch.no_grad():
            return model.encode_image_tokens(torch.from_numpy(vols).to(
                torch.bfloat16)).float().numpy()

    def rel(x, y):
        return float(np.linalg.norm(x - y) / np.linalg.norm(y))

    j8, jb, t8, tb = (jax_tokens(True), jax_tokens(False),
                      port_tokens(True), port_tokens(False))
    noise = rel(j8, jb)
    assert noise > 1e-3   # quantization moved the tokens
    assert abs(rel(t8, tb) / noise - 1) < 0.05


def test_gate_statistics_are_jaxs_on_jaxs_weights_and_the_gate_volumes():
    """JAX's CTCLIP at the tiny heads-packed arch (the production route
    K13 → K10 → K14 → K11) initialised from PRNGKey(0), unperturbed (the
    init's tails set the int8 weight scales), and the same parameters in
    the port; both at the bf16 policy, JAX jitted as its gate script runs
    it, over the gate's 200 volumes on its base noise, scored against one
    set of text latents.  Measured: the port's mean |Δprob| 1.6% above
    JAX's, τ and AUROC means within 4e-4 and 3e-5."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import torch

    from tests.test_torch_int8 import _config
    from tests.test_torch_models import (DIM_LATENT, POLICIES, TEXT_LEN,
                                         JaxBertConfig, JaxCTCLIP,
                                         jax_build_ctclip)
    from vit_exp_tpu.core.precision import FP32_POLICY as JAX_FP32
    from vit_exp_tpu_torch.models.bert import BertConfig
    from vit_exp_tpu_torch.models.convert import from_jax_params
    from vit_exp_tpu_torch.models.factory import build_ctclip

    config = _config("heads_packed")
    a = config.arch
    init_model = jax_build_ctclip(config, bert_config=JaxBertConfig.tiny(),
                                  policy=JAX_FP32, dim_latent=DIM_LATENT)
    video = jnp.zeros((1, 1, a.temporal_size, a.image_size, a.image_size))
    params = nn.unbox(jax.jit(lambda k, v, i: init_model.init(
        k, v, i, method=JaxCTCLIP.init_all))(
            jax.random.PRNGKey(0), video,
            jnp.ones((1, TEXT_LEN), jnp.int32)))["params"]
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                    params)
    ids = np.random.default_rng(0).integers(0, 128, (36, TEXT_LEN))
    ids = jnp.asarray(ids, jnp.int32)

    def jax_model(int8):
        return jax_build_ctclip(
            config, bert_config=JaxBertConfig.tiny(),
            policy=POLICIES["bf16"][0], dim_latent=DIM_LATENT,
            attn_impl="pallas_static_int8" if int8 else "pallas_static",
            ff_impl="pallas_int8" if int8 else "pallas", fuse_qkv=True)

    jb = jax_model(False)
    text = jax.jit(lambda p: jb.apply({"params": p}, jb.apply(
        {"params": p}, ids, jnp.ones_like(ids),
        method=JaxCTCLIP.encode_text_hidden),
        method=JaxCTCLIP.text_latents_from_hidden))(params)

    def jax_probs(int8):
        m = jax_model(int8)

        @jax.jit
        def run(p, v):
            tokens = m.apply({"params": p}, v,
                             method=JaxCTCLIP.encode_image_tokens)
            img = m.apply({"params": p}, tokens,
                          method=JaxCTCLIP.image_latents_from_tokens)
            scores = (img @ text.T) * jnp.exp(p["temperature"])
            return jax.nn.softmax(scores.reshape(v.shape[0], 18, 2),
                                  axis=-1)[..., 0]
        return lambda v: np.asarray(run(params, jnp.asarray(
            v.float().numpy(), jnp.bfloat16)))

    state = {k: torch.from_numpy(np.array(v)) for k, v in
             from_jax_params(params).items()}
    text_t = torch.from_numpy(np.asarray(text))

    def port_probs(int8):
        m = build_ctclip(config, BertConfig.tiny(), device="cpu",
                         policy=POLICIES["bf16"][1], dim_latent=DIM_LATENT,
                         fuse_qkv=True, int8=int8)
        m.load_state_dict(state)

        def run(v):
            with torch.no_grad():
                tokens = m.encode_image_tokens(v)
                img = torch.cat([m.image_latents_from_tokens(t)
                                 for t in tokens.split(1)])
                scores = (img @ text_t.T) * m.logit_scale()
                return torch.softmax(scores.reshape(v.shape[0], 18, 2),
                                     dim=-1)[..., 0].numpy()
        return run

    arch = dict(temporal_size=a.temporal_size, image_size=a.image_size)
    base = int8_gate.gate_base("cpu", arch, int8_gate.GATE_BASE_SEEDS[0])
    runs = {"j8": jax_probs(True), "jb": jax_probs(False),
            "t8": port_probs(True), "tb": port_probs(False)}
    probs = {k: [] for k in runs}
    for i in range(50):   # the gate's 50 batches of GATE_BATCH volumes
        vols = int8_gate.gate_volumes(base, 100 + i)
        for k, run in runs.items():
            probs[k].append(run(vols))
    probs = {k: np.concatenate(v) for k, v in probs.items()}
    jax_s = int8_gate.gate_stats(probs["j8"], probs["jb"])
    port_s = int8_gate.gate_stats(probs["t8"], probs["tb"])
    assert jax_s["volumes"] == port_s["volumes"] == 200
    assert jax_s["dmean"] > 1e-4   # quantization moved the probabilities
    assert abs(port_s["dmean"] / jax_s["dmean"] - 1) < 0.05
    assert abs(port_s["tau_mean"] - jax_s["tau_mean"]) < 2e-3
    assert abs(port_s["auroc_mean"] - jax_s["auroc_mean"]) < 5e-4


@pytest.mark.parametrize("witnesses", [False, True])
def test_the_script_on_the_cpu_prints_its_verdict(witnesses):
    bases = ["1", "2"] if witnesses else []
    res = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "int8_accuracy_gate_torch.py"),
         "--device", "cpu", "--volumes", "8"]
        + (["--witnesses", "--bases", *bases] if witnesses else []),
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    out = res.stdout
    seeds = bases or [str(s) for s in int8_gate.GATE_BASE_SEEDS]
    for s in seeds:
        assert f"base {s}: int8 vs bf16 over 8 volumes" in out, \
            res.stderr[-2000:]
    assert "rank AUROC" in out and "Kendall tau" in out
    for name in ("bf16 plain vs bf16", "int8 plain vs bf16",
                 "int8 plain vs bf16 plain"):
        assert all((f"witness, base {s}: {name} over 8" in out) == witnesses
                   for s in seeds)
    verdict = out.strip().splitlines()[-1]
    assert verdict in ("INT8 ACCURACY GATE: PASS", "INT8 ACCURACY GATE: FAIL")
    assert res.returncode == (0 if verdict.endswith("PASS") else 1)
