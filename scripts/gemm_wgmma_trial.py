#!/usr/bin/env python3
"""K2's and K8's product stages on one NVIDIA GPU (sm_90a), against another
checkout's kernels.

    python scripts/gemm_wgmma_trial.py [--parent DIR] [--rates]
    python scripts/gemm_wgmma_trial.py --variants

Builds the kernel library of this checkout (``_build.build``) and prints
ptxas's registers, spills and wgmma notes for the five product kernels on
``csrc/gemm_wgmma.cuh`` (K2's act and out, K8's dh, dy and weight GEMM).
At production shape (55,296 tokens, D 768, 2I 4,096) it runs each stage
against its plain twin (relative L2 ≤ 1e-2) and twice for the same bits,
then times it (mean of 20 launches after a warm-up, CUDA events) beside its
bound (operations at 989 TFLOP/s bf16 or bytes at 3.35 TB/s, the larger)
and torch.mm on the same products (a yardstick, never on the path).

--parent DIR: the root of another checkout (a ``git archive`` of the parent
commit, unpacked under ``build/``).  Its ``csrc/`` is built with this
checkout's flags into a library of its own and its stages are called
through the same C entry points on the same inputs; the two are timed in
turns (parent, this, this, parent), and the parent's outputs are held to
the same twins and compared with this checkout's bit for bit.

--rates: bf16 serving (volumes/s, batch 4, median of 5 warm
``predict_batch`` calls) and the contrastive train step (steps/s at K1 and
at K15, median of 5 warm steps) of each checkout, each in a process of its
own that imports that checkout's package and ``chip_smoke`` helpers, in
turns (parent, this, this, parent).

--variants: instead, builds each entry of VARIANTS (a copy of a source
with some lines rewritten: another tiling, another store path, an
ablation) into a library of its own and times its stage on the same
inputs, with its relative L2 against the twin and ptxas's spill bytes.

Prints the card's name and power limit as nvidia-smi gives them, and one
JSON line with every number.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from vit_exp_tpu_torch.ops import _build, geglu_ff  # noqa: E402

M, D, I2 = 55_296, 768, 4_096
KERNELS = ("geglu_ff_h_kernel", "geglu_ff_o_kernel", "geglu_bwd_dh_kernel",
           "geglu_bwd_dy_kernel", "wgrad_kernel")
PEAK_BF16, HBM = 989e12, 3.35e12
RTOL = 1e-2


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def build_tree(csrc: Path, out: Path) -> tuple:
    """A library from the .cu files of csrc (this checkout's nvcc flags):
    (path, compiler log)."""
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    cus = sorted(csrc.glob("*.cu"))
    objs = [out / (p.stem + ".o") for p in cus]
    with concurrent.futures.ThreadPoolExecutor(len(cus)) as pool:
        logs = list(pool.map(lambda so: _build._run(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(csrc), "-c", str(so[0]),
             "-o", str(so[1])]), zip(cus, objs)))
    lib = out / "libtree.so"
    logs.append(_build._run([nvcc, "-shared", *_build.NVCC_FLAGS[:2], "-o",
                             str(lib), *map(str, objs)]))
    return lib, "\n".join(logs)


def ptxas_lines(log: str) -> list:
    """The ptxas lines of the five kernels' entries, and every line that
    mentions wgmma."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        if "wgmma" in line.lower() or (
                entry and any(k in entry for k in KERNELS)
                and ("registers" in line or "spill" in line)):
            out.append(f"{entry}: {line.strip()}")
    return out


class Lib:
    """The five stages of one library, called through its C entry points
    on PyTorch's current stream."""

    def __init__(self, path: Path):
        self.h = ctypes.CDLL(str(path))

    def call(self, name, *args):
        fn = getattr(self.h, name)
        fn.argtypes, fn.restype = _build.SIGNATURES[name], ctypes.c_int
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")

    def stages(self, t):
        """name → a function that launches the stage into t's buffers."""
        p = {k: v.data_ptr() for k, v in t.items() if torch.is_tensor(v)}
        plans = t["plans"]
        return {
            "K2h": lambda: self.call("vit_geglu_ff_h", p["xn"], p["w1p"],
                                     p["d1"], p["o_act"], M, D, I2),
            "K2o": lambda: self.call("vit_geglu_ff_o", p["act"], p["w2"],
                                     p["o_out"], M, D, I2),
            "K8dh": lambda: self.call("vit_geglu_bwd_dh", p["y"], p["dout"],
                                      p["w1"], p["w2"], p["o_dh"],
                                      p["o_act8"], M, D, I2),
            "K8dy": lambda: self.call("vit_geglu_bwd_dy", p["dh"], p["w1"],
                                      p["o_dy"], M, D, I2),
            "K8w": lambda: [self.call("vit_wgrad", p[a], p[b], p[o], M, P,
                                      Q, P, Q, *plan)
                            for (a, b, o, P, Q), plan in zip(
                                (("y", "dh", "o_dw1", D, I2),
                                 ("act", "dout", "o_dw2", I2 // 2, D)),
                                plans)],
        }


def inputs(device) -> dict:
    g = torch.Generator(device=device).manual_seed(20)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=device) * std).to(bf)

    inner = I2 // 2
    x = randn(M, D)
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    t = dict(xn=geglu_ff.geglu_ff_x_plain(x, mu, inv),
             w1p=randn(D, I2, std=D ** -0.5), d1=randn(I2, std=0.1).float(),
             w2=randn(inner, D, std=inner ** -0.5), y=randn(M, D),
             dout=randn(M, D, std=1e-3), w1=randn(D, I2, std=D ** -0.5))
    t["act"] = geglu_ff.geglu_ff_h_plain(t["xn"], t["w1p"], t["d1"])
    t["dh"] = geglu_ff.geglu_bwd_dh_plain(t["y"], t["dout"], t["w1"],
                                          t["w2"])[0]
    t["plans"] = [geglu_ff.wgrad_plan(M, D, I2),
                  geglu_ff.wgrad_plan(M, inner, D)]
    empty = torch.empty
    t.update(o_act=empty(M, inner, device=device, dtype=bf),
             o_out=empty(M, D, device=device, dtype=bf),
             o_dh=empty(M, I2, device=device, dtype=bf),
             o_act8=empty(M, inner, device=device, dtype=bf),
             o_dy=empty(M, D, device=device),
             o_dw1=empty(t["plans"][0][0], D, I2, device=device),
             o_dw2=empty(t["plans"][1][0], inner, D, device=device))
    return t


def outputs(t, stage):
    return {"K2h": ("o_act",), "K2o": ("o_out",), "K8dh": ("o_dh", "o_act8"),
            "K8dy": ("o_dy",), "K8w": ("o_dw1", "o_dw2")}[stage]


def twins(t) -> dict:
    """Each stage's plain outputs, in the order of outputs()."""
    f = geglu_ff
    return {
        "K2h": [f.geglu_ff_h_plain(t["xn"], t["w1p"], t["d1"])],
        "K2o": [f.geglu_ff_o_plain(t["act"], t["w2"])],
        "K8dh": list(f.geglu_bwd_dh_plain(t["y"], t["dout"], t["w1"],
                                          t["w2"])),
        "K8dy": [f.geglu_bwd_dy_plain(t["dh"], t["w1"])],
        "K8w": [f.wgrad_partials_plain(t["y"], t["dh"], *t["plans"][0]),
                f.wgrad_partials_plain(t["act"], t["dout"], *t["plans"][1])],
    }


def rel(a, b) -> float:
    a, b = a.float(), b.float()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b)).item()


def cuda_ms(fn, iters=20) -> float:
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bounds(t) -> dict:
    inner = I2 // 2
    flops = {"K2h": 2 * M * D * I2, "K2o": 2 * M * inner * D,
             "K8dh": 2 * M * D * 3 * inner, "K8dy": 2 * M * I2 * D,
             "K8w": 2 * M * D * 3 * inner}
    nb = {s: sum(t[k].numel() * t[k].element_size() for k in ks) for s, ks in
          {"K2h": ("xn", "w1p", "d1", "o_act"), "K2o": ("act", "w2", "o_out"),
           "K8dh": ("y", "dout", "w1", "w2", "o_dh", "o_act8"),
           "K8dy": ("dh", "w1", "o_dy"),
           "K8w": ("y", "dh", "act", "dout", "o_dw1", "o_dw2")}.items()}
    return {s: max(flops[s] / PEAK_BF16, nb[s] / HBM) * 1e3 for s in flops}


def mm_yardsticks(t) -> dict:
    """torch.mm on each stage's products (bf16 out), the products only."""
    mm = torch.mm
    calls = {
        "K2h": lambda: mm(t["xn"], t["w1p"]),
        "K2o": lambda: mm(t["act"], t["w2"]),
        "K8dh": lambda: (mm(t["dout"], t["w2"].t()), mm(t["y"], t["w1"])),
        "K8dy": lambda: mm(t["dh"], t["w1"].t()),
        "K8w": lambda: (mm(t["y"].t(), t["dh"]), mm(t["act"].t(), t["dout"])),
    }
    return {s: cuda_ms(fn) for s, fn in calls.items()}


def stage_trial(parent: Path | None) -> dict:
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib_path = _build.build()
    log = lib_path.with_suffix(".log").read_text()
    for line in ptxas_lines(log):
        print(f"this tree, ptxas {line}", flush=True)
    libs = {"this": Lib(lib_path)}
    if parent is not None:
        ppath, plog = build_tree(parent / "vit_exp_tpu_torch" / "csrc",
                                 Path(tempfile.mkdtemp(prefix="parent_lib_")))
        for line in ptxas_lines(plog):
            print(f"parent, ptxas {line}", flush=True)
        libs["parent"] = Lib(ppath)
    t = inputs(device)
    ref = twins(t)
    res = {"card": card(), "rows": {}}
    order = ["parent", "this", "this", "parent"] if parent else ["this"]
    times = {s: {k: [] for k in libs} for s in ref}
    kept = {}
    for who, lib in libs.items():
        stages = lib.stages(t)
        for s, fn in stages.items():
            fn()
            torch.cuda.synchronize()
            first = [t[o].clone() for o in outputs(t, s)]
            fn()
            torch.cuda.synchronize()
            same = all(torch.equal(a, t[o]) for a, o in zip(first,
                                                            outputs(t, s)))
            errs = [rel(t[o], r) for o, r in zip(outputs(t, s), ref[s])]
            print(f"{who} {s}: rel L2 against the twin {errs} (≤ {RTOL}), "
                  f"same bits twice: {same}", flush=True)
            res["rows"].setdefault(s, {})[f"{who}_rel_l2"] = max(errs)
            res["rows"][s][f"{who}_same_bits"] = same
            if who == "this":
                kept[s] = first
            else:
                equal = all(torch.equal(a, t[o]) for a, o in zip(
                    kept[s], outputs(t, s)))
                print(f"{s}: the parent's bits equal this tree's: {equal}",
                      flush=True)
                res["rows"][s]["bits_equal_parent"] = equal
    for who in order:
        for s, fn in libs[who].stages(t).items():
            times[s][who].append(cuda_ms(fn))
    lib_ms = mm_yardsticks(t)
    bnd = bounds(t)
    for s in ref:
        row = res["rows"][s]
        row.update({f"{k}_ms": statistics.mean(v) for k, v in times[s].items()},
                   bound_ms=bnd[s], mm_ms=lib_ms[s])
        row["share"] = bnd[s] / row["this_ms"]
        print(f"{s}: this {row['this_ms']:.4f} ms"
              + (f", parent {row['parent_ms']:.4f} ms" if parent else "")
              + f", bound {bnd[s]:.4f} ms (share {row['share']:.3f}), "
              f"torch.mm on the products {lib_ms[s]:.4f} ms", flush=True)
    return res


RATES_CODE = r"""
import json, statistics, sys, time, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from vit_exp_tpu_torch.eval.int8_gate import build_engine
from vit_exp_tpu_torch.models.bert import BertConfig
dev = torch.device("cuda")
bert = BertConfig()
eng = build_engine(dev, cs.ARCH, bert, cs.TEXT_LEN)
eng.prepare()
g = torch.Generator(device=dev).manual_seed(1)
vol = torch.randn((cs.BATCH, 1, cs.ARCH["temporal_size"], cs.ARCH["image_size"],
                   cs.ARCH["image_size"]), generator=g, device=dev).to(torch.bfloat16)
eng.predict_batch(vol)
ts = []
for _ in range(5):
    t0 = time.perf_counter(); eng.predict_batch(vol); ts.append(time.perf_counter() - t0)
out = {"serve_vps": cs.BATCH / statistics.median(ts)}
del eng
torch.cuda.empty_cache()
for impl in ("pallas_static", "pallas"):
    model, opt, step = cs.build_trainer(dev, cs.ARCH, bert, attn_impl=impl)
    batch = cs.train_batch(dev, cs.ARCH, bert.vocab_size, cs.BATCH, cs.TEXT_LEN)
    for _ in range(2):
        float(step(batch, 1.0)["loss"])
    ts = []
    for _ in range(5):
        t0 = time.perf_counter(); float(step(batch, 1.0)["loss"]); ts.append(time.perf_counter() - t0)
    out[f"step_sps_{impl}"] = 1.0 / statistics.median(ts)
    del model, opt, step, batch
    torch.cuda.empty_cache()
print("RATES " + json.dumps(out), flush=True)
"""


def rates(parent: Path) -> dict:
    trees = {"parent": parent, "this": ROOT}
    out = {}
    for who in ("parent", "this", "this", "parent"):
        res = subprocess.run([sys.executable, "-c", RATES_CODE,
                              str(trees[who])], cwd=str(trees[who]),
                             capture_output=True, text=True)
        line = [x for x in res.stdout.splitlines() if x.startswith("RATES ")]
        if res.returncode or not line:
            raise RuntimeError(f"{who}: {res.stdout[-2000:]}\n"
                               f"{res.stderr[-4000:]}")
        got = json.loads(line[0][6:])
        print(f"{who}: {got}", flush=True)
        for k, v in got.items():
            out.setdefault(k, {}).setdefault(who, []).append(v)
    return out


# Variants of one source (a copy rewritten line by line, built alone into a
# library of its own) and the stage each one times: (label, source,
# {shipped text: variant text}, stage).  Ablations drop work, so only their
# time is read.
K2O_STAGED = """#pragma unroll
        for (int part = 0; part < 2; ++part) {
            out.acquire();"""
K2O_DIRECT = """#pragma unroll
        for (int j = 0; j < OGemm::N / 8; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = m0 + wg_row(2 * half);
                const int col = n0 + wg_col(j, 0);
                if (row < M && col < D)
                    store_bf16x2(out_ptr + (size_t)row * D + col,
                                 acc[j][2 * half], acc[j][2 * half + 1]);
            }
        for (int part = 0; part < 0; ++part) {
            out.acquire();"""
VARIANTS = [
    ("K2o shipped", "geglu_ff.cu", {}, "K2o"),
    ("K2o 3 stages", "geglu_ff.cu",
     {"O_COLS = 256, O_STAGES = 4": "O_COLS = 256, O_STAGES = 3"}, "K2o"),
    ("K2o stores from the registers", "geglu_ff.cu",
     {K2O_STAGED: K2O_DIRECT,
      "const __grid_constant__ CUtensorMap out_map, int M, int D,":
      "const __grid_constant__ CUtensorMap out_map, bf16* out_ptr, int M, "
      "int D,",
      "act_map, w2_map, out_map, M, D, inner);":
      "act_map, w2_map, out_map, (bf16*)out, M, D, inner);"}, "K2o"),
    ("K2h shipped", "geglu_ff.cu", {}, "K2h"),
    ("K2h 3 stages", "geglu_ff.cu",
     {"H_COLS = 128, H_STAGES = 4": "H_COLS = 128, H_STAGES = 3"}, "K2h"),
    ("K2h ablation: act = gate·val, no erf", "geglu_ff.cu",
     {"bf16_round(gelu_erf(g.x)) * val.x": "g.x * val.x",
      "bf16_round(gelu_erf(g.y)) * val.y": "g.y * val.y"}, "K2h"),
    ("K8dh shipped", "geglu_ff_bwd.cu", {}, "K8dh"),
    ("K8dh 128 columns, 3 stages", "geglu_ff_bwd.cu",
     {"DH_COLS = 64, DH_STAGES = 6": "DH_COLS = 128, DH_STAGES = 3"}, "K8dh"),
    ("K8dh ablation: no dact mainloop", "geglu_ff_bwd.cu",
     {"produce<DactGemm>(ring, &dout_map, m0, w2t, n1, 0, D);": "",
      "consume<DactGemm>(ring, da, 0, D);": ""}, "K8dh"),
    ("K8dy shipped", "geglu_ff_bwd.cu", {}, "K8dy"),
    ("K8w shipped", "geglu_ff_bwd.cu", {}, "K8w"),
    ("K8w 128 columns, 6 stages", "geglu_ff_bwd.cu",
     {"WG_Q = 256, WG_STAGES = 4": "WG_Q = 128, WG_STAGES = 6"}, "K8w"),
]


STAGE_KERNEL = dict(zip(("K2h", "K2o", "K8dh", "K8dy", "K8w"), KERNELS))


def variant_trial() -> dict:
    """Each of VARIANTS built and timed on the same inputs (mean of 20
    launches after a warm-up), in turns: forward, then backward."""
    device = torch.device("cuda")
    t = inputs(device)
    ref = twins(t)
    work = Path(tempfile.mkdtemp(prefix="wgmma_variants_"))

    def build(i, v):
        label, src, subs, _ = v
        text = (_build.CSRC / src).read_text()
        for a, b in subs.items():
            if text.count(a) != 1:
                raise RuntimeError(f"{label}: {a!r} not found once")
            text = text.replace(a, b)
        cu = work / f"v{i}.cu"
        cu.write_text(text)
        lib = work / f"libv{i}.so"
        log = _build._run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                           "-I", str(_build.CSRC), "-o", str(lib), str(cu)])
        return lib, log

    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda iv: build(*iv), enumerate(VARIANTS)))
    out = {}
    for (label, _, _, stage), (lib, log) in zip(VARIANTS, built):
        spills = [m.group(2) for m in re.finditer(
            r"entry function '(\w+)'[^\n]*\n(?:[^\n]*\n){0,2}?[^\n]*?"
            r"(\d+) bytes spill stores", log)
            if STAGE_KERNEL[stage] in m.group(1)]
        st = Lib(lib).stages(t)[stage]
        st()
        torch.cuda.synchronize()
        errs = [rel(t[o], r) for o, r in zip(outputs(t, stage), ref[stage])]
        ms = statistics.mean(cuda_ms(st) for _ in range(2))
        out[label] = dict(ms=ms, rel_l2=max(errs),
                          spill_bytes=max(map(int, spills or [0])))
        print(f"variant {label}: {ms:.4f} ms, rel L2 {max(errs):.3e}, "
              f"spill stores {out[label]['spill_bytes']}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--rates", action="store_true")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.variants:
        res = {"card": card(), "variants": variant_trial()}
        print(f"card: {res['card']}", flush=True)
        print(json.dumps(res), flush=True)
        return 0
    res = stage_trial(args.parent)
    bad = [s for s, r in res["rows"].items()
           if r["this_rel_l2"] > RTOL or not r["this_same_bits"]]
    if args.rates and args.parent is not None:
        res["rates"] = rates(args.parent.resolve())
    print(f"card: {res['card']}", flush=True)
    print(json.dumps(res), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
