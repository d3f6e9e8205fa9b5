"""Subprocess body of tests/test_torch_ring.py and tests/test_torch_dist.py:
one rank of a process group of the PyTorch port on the CPU (gloo).  It
imports no jax: the tests compute the JAX side in their own process and
hand it over as pickled numpy.

    python tests/_torch_dist_runner.py JOB RANK WORLD WORKDIR [ARGS...]

- ``ring``: ring attention, cosine attention with ``ring_group``, the
  sequence-sharded tower's encode and the contrastive objective through
  it, on WORKDIR/inputs.pkl, in a group joined through the file store
  WORKDIR/store;
- ``dp``: one data-parallel train step of each case of WORKDIR/inputs.pkl
  on this rank's rows of the global batch, in such a group;
- ``mesh``: one train step of each case of WORKDIR/inputs.pkl on a grid
  (``inputs["mesh"]``, DATA,FSDP,MODEL), on this rank's batch shard, the
  parameters placed by parallel/sharding.py, in such a group; the
  gathered parameters, the grid's layout and the per-rank bytes come back;
- ``train``, ``cls`` and ``seg``: ``run_train.main(ARGS)``,
  ``run_zero_shot_cls.main(ARGS)`` and ``run_zero_shot_seg.main(ARGS)``
  on the CPU; ARGS carry the multi-host flags (or none, for the
  one-process reference); ``cls`` also records each int8 block's local k
  amax; ``sigterm_rank1``: ``train`` with a SIGTERM to rank 1 after its
  first step.

Each writes what it saw to WORKDIR/out{RANK}.pkl.  ``start`` and
``spawn`` (for the tests) run the ranks and return their outputs.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LONG_KEYS = {"input_ids", "attention_mask", "prompt_ids", "prompt_mask"}


def free_port():
    """A TCP port on localhost that nothing listens on now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start(job, world, workdir, inputs=None, args=None):
    """Start ranks 0..world−1 of ``job`` (``inputs`` pickled for them;
    ``args(rank)`` the CLI arguments of each); returns ``finish``, which
    waits for them and returns their outputs in rank order (a rank that
    failed fails the caller with its output)."""
    os.makedirs(workdir, exist_ok=True)
    if inputs is not None:
        with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK")}
    env.update(PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r), str(world),
         workdir, *(args(r) if args else [])], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]

    def finish(timeout=240):
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, \
                f"rank {r} of {job} failed:\n{log[-4000:]}"
        outs = []
        for r in range(world):
            with open(os.path.join(workdir, f"out{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs

    return finish


def spawn(job, world, workdir, inputs=None, args=None, timeout=240):
    """``start`` and wait: the ranks' outputs in rank order."""
    return start(job, world, workdir, inputs, args)(timeout)


def _load(workdir):
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        return pickle.load(f)


def _model(config_dict, state, group=None, bert=None):
    from vit_exp_tpu_torch.core import config as tconfig
    from vit_exp_tpu_torch.core.precision import FP32_POLICY
    from vit_exp_tpu_torch.models.bert import BertConfig
    from vit_exp_tpu_torch.models.factory import build_ctclip

    cfg = tconfig.ExperimentConfig.from_dict(config_dict)
    bert = BertConfig(**bert) if bert else BertConfig.tiny()
    model = build_ctclip(cfg, bert, device="cpu", policy=FP32_POLICY,
                         dim_latent=16, attn_impl="pallas")
    res = model.load_state_dict({k: torch.from_numpy(v)
                                 for k, v in state.items()})
    assert not res.missing_keys and not res.unexpected_keys
    model.visual_transformer.seq_group = group
    return cfg, model.train()


def _grads(model, group):
    """Every parameter's gradient averaged over the group (the text tower
    and heads without one get zeros), by name."""
    from vit_exp_tpu_torch.parallel.collectives import average_gradients

    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    average_gradients(model.parameters(), group)
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters()}


def ring_job(inp, group):
    from vit_exp_tpu_torch.models.losses import infonce_loss
    from vit_exp_tpu_torch.ops.attention import cosine_attention
    from vit_exp_tpu_torch.ops.ring_attention import ring_attention

    r, w = dist.get_rank(group), dist.get_world_size(group)

    def local(x):
        n = x.shape[2] // w
        return torch.from_numpy(x[:, :, r * n:(r + 1) * n].copy()
                                ).requires_grad_()

    out = {}
    q, k, v = (local(inp["ring"][n]) for n in "qkv")
    o = ring_attention(q, k, v, group=group)
    o.square().sum().backward()
    out["ring"] = {"out": o.detach().numpy(), "dq": q.grad.numpy(),
                   "dk": k.grad.numpy(), "dv": v.grad.numpy()}

    c = inp["cosine"]
    q, k, v = (local(c[n]) for n in "qkv")
    fixed = {n: torch.from_numpy(c[n]) for n in
             ("null_k", "null_v", "q_scale", "k_scale")}
    o = cosine_attention(q, k, v, scale=8.0, static_max=False,
                         ring_group=group, **fixed)
    o.square().sum().backward()
    out["cosine"] = {"out": o.detach().numpy(), "dq": q.grad.numpy(),
                     "dk": k.grad.numpy(), "dv": v.grad.numpy()}

    t = inp["tower"]
    video = torch.from_numpy(t["video"])
    _, model = _model(t["config"], t["state"], group)
    tokens = model.encode_image_tokens(video)
    tokens.square().sum().backward()
    out["encode"] = {"out": tokens.detach().numpy(),
                     "grads": _grads(model, group)}

    model.zero_grad(set_to_none=True)
    res = model(video, torch.from_numpy(t["ids"]).long(),
                torch.from_numpy(t["mask"]).long())
    loss = infonce_loss(res["text_latents"], res["image_latents"],
                        res["temperature"], local_batch_size=2)
    loss.backward()
    out["contrastive"] = {"loss": float(loss), "grads": _grads(model, group)}
    return out


def dp_job(inp, group):
    from vit_exp_tpu_torch.train.optimizer import build_optimizer
    from vit_exp_tpu_torch.train.steps import make_train_steps

    r = dist.get_rank(group)
    out = {}
    for name, case in inp.items():
        cfg, model = _model(case["config"], case["state"])
        opt = build_optimizer(cfg.trainer, model.parameters(), group=group)
        step = make_train_steps(model, opt, cfg, group=group)[case["type"]]
        lb = case["local_batch"]
        batch = {}
        for key, x in case["batch"].items():
            if key not in ("prompt_ids", "prompt_mask"):
                x = x[r * lb:(r + 1) * lb]
            x = torch.from_numpy(np.array(x))
            batch[key] = x.long() if key in LONG_KEYS else x
        kw = {"draws": case["draws"]} if case.get("draws") else {}
        metrics = step(batch, 0.5, **kw)
        out[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                     "params": {n: p.detach().numpy().copy()
                                for n, p in model.named_parameters()}}
    return out


def mesh_job(inp):
    from vit_exp_tpu_torch.core.mesh import MeshConfig, grid
    from vit_exp_tpu_torch.parallel.sharding import Sharded
    from vit_exp_tpu_torch.train.optimizer import build_optimizer
    from vit_exp_tpu_torch.train.steps import make_train_steps

    g = grid(MeshConfig(*inp["mesh"]))
    out = {"coords": g.coords, "batch_index": g.batch_index,
           "groups": {k: (None if getattr(g, k) is None else
                          dist.get_process_group_ranks(getattr(g, k)))
                      for k in ("batch", "fsdp", "model", "replica")}}
    for name, case in inp["cases"].items():
        cfg, model = _model(case["config"], case["state"],
                            bert=case.get("bert"))
        sharding = Sharded(model, g)
        opt = build_optimizer(cfg.trainer, model.parameters(),
                              sharding=sharding)
        step = make_train_steps(model, opt, cfg, group=g.batch,
                                sharding=sharding)[case["type"]]
        lb, r = case["local_batch"], g.batch_index
        batch = {}
        for key, x in case["batch"].items():
            if key not in ("prompt_ids", "prompt_mask"):
                x = x[r * lb:(r + 1) * lb]
            x = torch.from_numpy(np.array(x))
            batch[key] = x.long() if key in LONG_KEYS else x
        kw = {"draws": case["draws"]} if case.get("draws") else {}
        metrics = step(batch, 0.5, **kw)
        moments = [v for s in opt.opt.state.values() for v in s.values()
                   if torch.is_tensor(v) and v.dim()]
        out[name] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grad_norm": float(opt.grad_norm),
            "params": {n: v.numpy().copy() for n, v in
                       sharding.full_state_dict().items()},
            "bytes": {"params": sum(p.numel() * p.element_size()
                                    for p in model.parameters()),
                      "grads": sum(p.grad.numel() * p.grad.element_size()
                                   for p in model.parameters()),
                      "moments": sum(m.numel() * m.element_size()
                                     for m in moments)}}
    return out


def train_job(argv, sigterm_after=None):
    """run_train.main(argv); with ``sigterm_after`` a SIGTERM to this
    process once that step is done."""
    from vit_exp_tpu_torch.cli import run_train
    from vit_exp_tpu_torch.train import checkpoint
    from vit_exp_tpu_torch.train.trainer import CTClipTrainer
    from vit_exp_tpu_torch.utils import logging as tlogging

    if sigterm_after is not None:
        import signal

        step = CTClipTrainer.train_step

        def train_step(self):
            out = step(self)
            if self.step == sigterm_after:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        CTClipTrainer.train_step = train_step

    logged, written = [], []
    log, write = tlogging.MetricLogger.log, checkpoint.CheckpointManager._write

    def record_log(self, metrics, step=None):
        logged.append((step, dict(metrics)))
        return log(self, metrics, step)

    def record_write(self, step, *args):
        written.append(step)
        return write(self, step, *args)

    layout = {}
    make = run_train.make_trainer

    def make_trainer(args, device):
        """The trainer, with its grid's groups read while they exist."""
        trainer = make(args, device)
        g = trainer.grid
        layout.update(coords=g.coords, groups={
            k: (None if getattr(g, k) is None
                else dist.get_process_group_ranks(getattr(g, k)))
            for k in ("batch", "fsdp", "model", "replica")})
        return trainer

    tlogging.MetricLogger.log = record_log
    checkpoint.CheckpointManager._write = record_write
    run_train.make_trainer = make_trainer
    trainer = run_train.main(argv, device="cpu")
    loader = trainer.loaders[0].loader
    epoch, loader.epoch = loader.epoch, 0
    indices = loader._batch_indices()
    loader.epoch = epoch
    trainer.close()
    return {"status": trainer.status, "step": trainer.step,
            "grid": layout,
            "logged": logged, "written": written,
            "latest": trainer.ckpt.latest_step(),
            "logger_enabled": trainer.logger.enabled,
            "shard": (loader.shard_id, loader.num_shards, loader.batch_size),
            "indices": indices}


def cls_job(argv):
    from vit_exp_tpu_torch.cli import run_zero_shot_cls
    from vit_exp_tpu_torch.ops import attention

    amaxes, quantize = [], attention.quantize_qk

    def record(q, k, scale, amax_reduce=None):
        amaxes.append(float(k.float().abs().amax()))
        return quantize(q, k, scale, amax_reduce)

    attention.quantize_qk = record
    return {"result": run_zero_shot_cls.main(argv, device="cpu"),
            "local_k_amax": amaxes}


def seg_job(argv):
    from vit_exp_tpu_torch.cli import run_zero_shot_seg

    return {"result": run_zero_shot_seg.main(argv, device="cpu")}


def main():
    job, rank, world, workdir = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    if job in ("ring", "dp", "mesh"):
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
            rank=rank, world_size=world)
        inp = _load(workdir)
        out = (mesh_job(inp) if job == "mesh" else
               (ring_job if job == "ring" else dp_job)(inp, dist.group.WORLD))
        dist.destroy_process_group()
    elif job == "train":
        out = train_job(sys.argv[5:])
    elif job == "sigterm_rank1":
        out = train_job(sys.argv[5:], sigterm_after=1 if rank == 1 else None)
    elif job == "seg":
        out = seg_job(sys.argv[5:])
    else:
        out = cls_job(sys.argv[5:])
    with open(os.path.join(workdir, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in
                 ("jax", "jaxlib", "flax", "vit_exp_tpu"))
    assert not bad, bad


if __name__ == "__main__":
    main()
