"""The int8 serving accuracy gate (counterpart of
scripts/int8_accuracy_gate.py): the int8 zero-shot engine (W8A8 LN+qkv,
int8 attention, W8A8 feed-forward and out-projection, the JAX package's
serving default) against the bf16 engine on the same seeded random weights
and the same volumes, at the flagship arch (dim 768, 8 blocks, 13,824
tokens a volume), batch 4, 36 prompts of 512 tokens.

Each batch is one base noise volume plus a separable low-frequency field
(one random vector per slice, row and column) at a random amplitude, so the
18 probabilities spread across volumes: a per-volume affine change would
be removed by the first LayerNorm.  As the JAX script, the gate runs on one
base noise, GATE_BASE_SEEDS (a torch draw: the serving volumes of
chip_smoke.py; the JAX script's PRNGKey(42) draw cannot be made without
JAX), and holds

1. max |Δprob| ≤ ``MAX_PROB_DELTA`` over all volumes and labels, and
2. per label, with the bf16 probabilities split at their median into
   labels, the rank AUROC of the int8 probabilities ≥ ``MIN_RANK_AUROC``
   (the smallest over the labels that have both classes).

At random weights the second bound is a statistic of the draw, not of the
int8 route alone: the smallest of 18 labels' AUROCs is set by the
narrowest label (a spread of about 12 times the mean |Δprob|), and on
other base noises it falls on either side of the bar while the port's
quantization noise is JAX's (PERF.md).  chip_smoke.py prints the gate on
WITNESS_BASE_SEEDS beside it, not bounded; ``--bases`` bounds every base
it is given.

It also reports the probability spread, the mean |Δprob|, the mean AUROC
and Kendall τ per label.  The AUROC is the Mann-Whitney U with ties
averaged (``metrics.rank_auroc``; no sklearn on the card's host).  At 200
volumes the median split gives 100 positives and 100 negatives, so one
swapped pair moves a label's AUROC by 1e-4: the bound needs that many
volumes, not trained weights.  With ``--witnesses`` the int8 and bf16
engines on their plain twins (``use_kernels=False``) are read against the
same bf16 reference on each base, printed and not bounded: the int8 plain
engine tells the kernels' noise from the int8 route's own, the bf16 plain
one gives the floor of two bf16 implementations.

``main`` is the command line of scripts/int8_accuracy_gate_torch.py; on the
CPU (``--device cpu``) it runs the JAX script's CPU arch on the plain route
(``use_kernels=False``), a plumbing check of the script.
"""

from __future__ import annotations

import argparse
import time
import types

import numpy as np
import torch

from vit_exp_tpu_torch.eval.metrics import rank_auroc as _mann_whitney

MAX_PROB_DELTA = 0.02
MIN_RANK_AUROC = 0.995
# the flagship arch (bench.py's zero-shot program) and the JAX script's CPU
# arch
GATE_ARCH = dict(dim=768, image_size=480, patch_size=20, temporal_size=240,
                 temporal_patch_size=10, transformer_blocks=8, dim_head=32,
                 heads=8, channels=1, use_flash_attention=True)
CPU_ARCH = dict(dim=48, image_size=32, patch_size=8, temporal_size=16,
                temporal_patch_size=4, transformer_blocks=2, dim_head=8,
                heads=4, channels=1, use_flash_attention=True)
TEXT_LEN, CPU_TEXT_LEN = 512, 16
GATE_BATCH = 4
# the gate's base noise, a torch generator seed on the device: 1 draws the
# serving volumes of chip_smoke.py (the base of its earlier 16-volume
# check); the witness bases are the next three draws, read and printed
GATE_BASE_SEEDS = (1,)
WITNESS_BASE_SEEDS = (2, 3, 4)


def random_tokenizer(vocab_size: int, seed: int):
    """Seeded random prompt ids of full length (the benchmark's prompts)."""
    rng = np.random.default_rng(seed)

    def tokenize(prompts, max_length):
        ids = rng.integers(0, vocab_size, (len(prompts), max_length))
        return {"input_ids": ids, "attention_mask": np.ones_like(ids)}

    return tokenize


def build_engine(device, arch: dict, bert_config, text_len: int, *,
                 use_kernels: bool = True, int8: bool = False,
                 state_dict=None, seed: int = 0):
    """The zero-shot engine as served (fused LN+qkv), bf16 or int8, with
    seeded random weights or ``state_dict``."""
    from vit_exp_tpu_torch.eval.zero_shot import ZeroShotClassifier
    from vit_exp_tpu_torch.models.factory import build_ctclip

    model = build_ctclip(types.SimpleNamespace(**arch), bert_config,
                         device=device, use_kernels=use_kernels,
                         fuse_qkv=True, int8=int8, seed=seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    tok = random_tokenizer(bert_config.vocab_size, seed)
    return ZeroShotClassifier(model, tok, max_text_len=text_len)


def gate_base(device, arch: dict, seed: int,
              batch: int = GATE_BATCH) -> torch.Tensor:
    """A base noise of the gate: (batch, 1, T, H, W) bf16 standard normals
    on ``device`` from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((batch, 1, arch["temporal_size"], arch["image_size"],
                        arch["image_size"]), generator=g,
                       device=device).to(torch.bfloat16)


def gate_volumes(base: torch.Tensor, seed: int) -> torch.Tensor:
    """One batch of the gate: the base noise plus a separable low-frequency
    field (one random vector per slice, row and column) at a random
    amplitude in [0.3, 1.5), made on base's device from ``seed``."""
    g = torch.Generator(device=base.device).manual_seed(seed)
    b, _, t, hh, ww = base.shape

    def randn(*shape):
        return torch.randn(shape, generator=g, device=base.device)

    amp = 0.3 + 1.2 * torch.rand((b, 1, 1, 1, 1), generator=g,
                                 device=base.device)
    field = randn(b, 1, t, 1, 1) + randn(b, 1, 1, hh, 1) + randn(b, 1, 1, 1, ww)
    return (base.float() + amp * field).to(base.dtype)


def rank_auroc(scores: np.ndarray, labels: np.ndarray) -> float:
    """AUROC of scores against 0/1 labels (Mann-Whitney U, ties averaged)."""
    return _mann_whitney(labels, scores)


def kendall_tau(a: np.ndarray, b: np.ndarray) -> float:
    """Kendall tau-a, as scripts/int8_accuracy_gate.py computes it."""
    da = np.sign(a[:, None] - a[None, :])
    db = np.sign(b[:, None] - b[None, :])
    iu = np.triu_indices(len(a), 1)
    return float(np.mean(da[iu] * db[iu]))


def gate_probs(eng, base: torch.Tensor, n_batches: int,
               seed: int = 100) -> np.ndarray:
    """The engine's probabilities over n_batches batches of gate volumes
    (batch i from seed + i), (n_batches · batch, 18)."""
    return np.concatenate([eng.predict_batch(gate_volumes(base, seed + i))
                           for i in range(n_batches)])


def gate_stats(p8: np.ndarray, pb: np.ndarray) -> dict:
    """The gate's statistics of probabilities p8 against the reference pb:
    the volume count, max and mean |Δprob|, the spread (mean per-label std
    of pb), whether everything is finite, and per label with a median
    split of pb the min and mean rank AUROC of p8 and of Kendall τ, and
    each label's AUROC (None where a label has one class) and spread."""
    aurocs, taus, per_label = [], [], []
    for c in range(pb.shape[1]):
        labels = (pb[:, c] > np.median(pb[:, c])).astype(int)
        if labels.min() == labels.max():
            per_label.append(None)
            continue
        aurocs.append(rank_auroc(p8[:, c], labels))
        taus.append(kendall_tau(pb[:, c], p8[:, c]))
        per_label.append(aurocs[-1])
    return dict(volumes=len(p8), dmax=float(np.abs(p8 - pb).max()),
                dmean=float(np.abs(p8 - pb).mean()),
                spread=float(np.std(pb, axis=0).mean()),
                finite=bool(np.isfinite(p8).all() and np.isfinite(pb).all()),
                labels=len(aurocs),
                auroc_min=min(aurocs, default=float("nan")),
                auroc_mean=float(np.mean(aurocs)) if aurocs else float("nan"),
                tau_min=min(taus, default=float("nan")),
                tau_mean=float(np.mean(taus)) if taus else float("nan"),
                label_auroc=per_label,
                label_spread=[float(x) for x in np.std(pb, axis=0)])


def int8_accuracy(eng8, eng, base: torch.Tensor, n_batches: int,
                  seed: int = 100) -> dict:
    """The int8 engine against the bf16 engine over n_batches batches of
    gate volumes: ``gate_stats`` of their probabilities."""
    return gate_stats(gate_probs(eng8, base, n_batches, seed),
                      gate_probs(eng, base, n_batches, seed))


def gate(eng8, eng, device, arch: dict, n_batches: int,
         bases=GATE_BASE_SEEDS, batch: int = GATE_BATCH):
    """The gate on each base noise of ``bases`` (seeds): ({seed: the int8
    engine's ``gate_stats`` against the bf16 engine}, {seed: the bf16
    engine's probabilities})."""
    accs, refs = {}, {}
    for s in bases:
        base = gate_base(device, arch, s, batch)
        refs[s] = gate_probs(eng, base, n_batches)
        accs[s] = gate_stats(gate_probs(eng8, base, n_batches), refs[s])
    return accs, refs


def witnesses(device, arch: dict, bert_config, text_len: int, state_dict,
              refs: dict, n_batches: int, batch: int = GATE_BATCH,
              seed: int = 0) -> dict:
    """The bf16 and int8 engines on their plain twins, on ``state_dict``,
    against the bf16 reference probabilities ``refs`` ({base seed: probs},
    ``gate``'s second result), and the int8 plain engine against the bf16
    plain one: {(what was compared, base seed): gate_stats}."""
    probs, out = {}, {}
    for name, int8 in (("bf16 plain", False), ("int8 plain", True)):
        eng = build_engine(device, arch, bert_config, text_len,
                           use_kernels=False, int8=int8,
                           state_dict=state_dict, seed=seed)
        eng.prepare()
        for s, pb in refs.items():
            probs[name, s] = gate_probs(
                eng, gate_base(device, arch, s, batch), n_batches)
            out[f"{name} vs bf16", s] = gate_stats(probs[name, s], pb)
        del eng
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    for s in refs:
        out["int8 plain vs bf16 plain", s] = gate_stats(
            probs["int8 plain", s], probs["bf16 plain", s])
    return out


def verdict(acc: dict, max_prob_delta: float = MAX_PROB_DELTA,
            min_rank_auroc: float = MIN_RANK_AUROC) -> list:
    """Why the gate fails on ``acc`` (``int8_accuracy``'s result): empty
    when it passes."""
    fails = []
    if not acc["finite"]:
        fails.append("non-finite probabilities")
    if not acc["labels"]:
        fails.append("no label has probability spread: rank AUROC undefined")
    if not acc["dmax"] <= max_prob_delta:
        fails.append(f"max |Δprob| {acc['dmax']:.5f} > {max_prob_delta}")
    if acc["labels"] and not acc["auroc_min"] >= min_rank_auroc:
        fails.append(f"min rank AUROC {acc['auroc_min']:.5f} < "
                     f"{min_rank_auroc}")
    return fails


def gate_verdict(accs: dict, max_prob_delta: float = MAX_PROB_DELTA,
                 min_rank_auroc: float = MIN_RANK_AUROC) -> list:
    """Why the gate fails on any base of ``accs`` (``gate``'s first
    result), each reason led by its base: empty when it passes on all."""
    return [f"base {s}: {why}" for s, acc in accs.items()
            for why in verdict(acc, max_prob_delta, min_rank_auroc)]


def report(acc: dict, what: str = "int8 vs bf16") -> str:
    """One line of ``gate_stats``' numbers, led by ``what`` was compared."""
    return (f"{what} over {acc['volumes']} volumes: probability spread "
            f"(mean per-label std) {acc['spread']:.4f}; max |Δprob| "
            f"{acc['dmax']:.5f}, mean {acc['dmean']:.6f}; per-label rank "
            f"AUROC (against the reference's median labels, {acc['labels']} "
            f"labels) min {acc['auroc_min']:.5f} mean "
            f"{acc['auroc_mean']:.5f}; Kendall tau min {acc['tau_min']:.4f} "
            f"mean {acc['tau_mean']:.4f}")


def lowest_labels(acc: dict, n: int = 3) -> str:
    """The n labels of lowest rank AUROC: (AUROC, spread, label) each."""
    order = sorted((a, sp, c) for c, (a, sp) in enumerate(
        zip(acc["label_auroc"], acc["label_spread"])) if a is not None)
    return "; ".join(f"({a:.4f}, {sp:.5f}, {c})" for a, sp, c in order[:n])


def main(argv=None) -> int:
    """The gate's command line: 0 when it passes on every base, 1 when it
    fails on any."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--volumes", type=int, default=200,
                   help="volumes on each base noise")
    p.add_argument("--batch", type=int, default=GATE_BATCH)
    p.add_argument("--bases", type=int, nargs="+",
                   default=list(GATE_BASE_SEEDS),
                   help="the base noises' seeds")
    p.add_argument("--max_prob_delta", type=float, default=MAX_PROB_DELTA)
    p.add_argument("--min_rank_auroc", type=float, default=MIN_RANK_AUROC)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card, through the kernels) or cpu (the "
                        "CPU arch on the plain route)")
    p.add_argument("--seed", type=int, default=0, help="weights' seed")
    p.add_argument("--witnesses", action="store_true",
                   help="also read the int8 and bf16 engines on their "
                        "plain twins against the reference (printed)")
    args = p.parse_args(argv)

    from vit_exp_tpu_torch.models.bert import BertConfig

    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        arch, bert, text_len = GATE_ARCH, BertConfig(), TEXT_LEN
    else:
        arch, bert, text_len = CPU_ARCH, BertConfig.tiny(), CPU_TEXT_LEN
    n_batches = max(args.volumes // args.batch, 1)
    eng = build_engine(device, arch, bert, text_len, use_kernels=on_card,
                       seed=args.seed)
    eng8 = build_engine(device, arch, bert, text_len, use_kernels=on_card,
                        int8=True, state_dict=eng.model.state_dict(),
                        seed=args.seed)
    eng.prepare()
    eng8.prepare()
    where = (f"{torch.cuda.get_device_name(device)}, through the kernels"
             if on_card else "cpu, the plain route")
    t0 = time.perf_counter()
    accs, refs = gate(eng8, eng, device, arch, n_batches, args.bases,
                      args.batch)
    for s, acc in accs.items():
        print(f"base {s}: {report(acc)}; lowest labels (AUROC, spread, "
              f"label) {lowest_labels(acc)}", flush=True)
    print(f"({time.perf_counter() - t0:.1f} s on {where}, weights' seed "
          f"{args.seed})", flush=True)
    if args.witnesses:
        state = eng.model.state_dict()
        del eng8
        for (name, s), acc in witnesses(device, arch, bert, text_len, state,
                                        refs, n_batches, args.batch,
                                        args.seed).items():
            print(f"witness, base {s}: {report(acc, name)}; lowest labels "
                  f"{lowest_labels(acc)}", flush=True)
    fails = gate_verdict(accs, args.max_prob_delta, args.min_rank_auroc)
    for why in fails:
        print(f"FAIL: {why}")
    print("INT8 ACCURACY GATE:", "FAIL" if fails else "PASS", flush=True)
    return 1 if fails else 0
