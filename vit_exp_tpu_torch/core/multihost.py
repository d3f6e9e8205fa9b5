"""Multi-process set-up (counterpart of vit_exp_tpu/core/multihost.py).

The port runs one process per card: every process runs the same command,
and ``torch.distributed`` joins them into one group.  On a CUDA device the
group is NCCL; gloo is used only when the caller asks for the CPU (the
tests).  A failed NCCL set-up raises: there is no fallback to gloo.

The address, size and rank come from the flags (``add_cli_args``) or,
where a flag is not given, from torchrun's standard variables: MASTER_ADDR
and MASTER_PORT (the coordinator, ``host:port``), WORLD_SIZE and RANK.  A
flag always wins over its variable, a ``--process_id`` of 0 included.  A
coordinator given as a flag is joined at ``tcp://<host:port>`` (rank 0
serves it); one read from the variables through ``env://``, so that under
torchrun the ranks join the store its agent already serves.  A
process count above 1 or a rank above 0 without a coordinator raises (it
would be N independent runs that all think they are rank 0 and write the
same results folder); a run with none of them is a single process, and
every helper below is then a no-op.

The card of a process is ``cuda:<LOCAL_RANK>`` where torchrun sets it,
else ``cuda:<rank mod the cards this host sees>``.

``add_cli_args`` is the one helper the CLIs share: it adds ``--mesh`` (the
DATA,FSDP,MODEL sizes, core/mesh.py) with the three multi-host flags, and
``process_group(args, device)`` runs a ``main`` inside the group they
describe.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# how long a rank waits for the others to join, or in a collective
TIMEOUT = datetime.timedelta(minutes=10)


def _env_coordinator() -> Optional[str]:
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def local_rank(rank: Optional[int] = None) -> int:
    """The card index on its host of ``rank`` (this process's by
    default)."""
    if os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    rank = process_index() if rank is None else rank
    return rank % max(torch.cuda.device_count(), 1)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device="cuda") -> bool:
    """Join the process group (NCCL for a CUDA ``device``, gloo for the
    CPU) at the coordinator; returns True, or False for a single-process
    run (nothing to join)."""
    init_method = f"tcp://{coordinator_address}"
    if not coordinator_address:
        coordinator_address, init_method = _env_coordinator(), "env://"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if not coordinator_address:
        if num_processes not in (None, 1) or process_id not in (None, 0):
            raise ValueError(
                "--num_processes/--process_id (or WORLD_SIZE/RANK) describe "
                "a multi-process run but no --coordinator_address (or "
                "MASTER_ADDR and MASTER_PORT) is set; refusing to run as N "
                "independent single-process jobs")
        return False
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no process group backend for device {device!r}")
    world = int(num_processes if num_processes is not None else 1)
    rank = int(process_id if process_id is not None else 0)
    kw = dict(init_method=init_method, world_size=world, rank=rank,
              timeout=TIMEOUT)
    if kind == "cpu":
        dist.init_process_group("gloo", **kw)
        return True
    if not torch.cuda.is_available():
        raise RuntimeError("an NCCL group needs a CUDA device and this "
                           "process sees none (gloo is for device='cpu')")
    card = local_rank(rank)
    torch.cuda.set_device(card)
    # device_id makes NCCL set up its communicator now, so a failure
    # raises here rather than at the first collective
    dist.init_process_group("nccl", device_id=torch.device("cuda", card),
                            **kw)
    return True


def add_cli_args(parser):
    """``--mesh`` and the multi-host flags, shared by the training and
    scoring CLIs."""
    parser.add_argument("--mesh", default=None, metavar="DATA,FSDP,MODEL",
                        help="the process grid's axis sizes; their product "
                        "is the process count (one process per card)")
    parser.add_argument("--coordinator_address", default=None,
                        metavar="HOST:PORT",
                        help="rank 0's address; with --num_processes and "
                        "--process_id, run the same command once per card")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    return parser


def initialize_from_args(args, device="cuda") -> bool:
    """initialize() from the add_cli_args flags; call it before any CUDA
    work."""
    return initialize(args.coordinator_address, args.num_processes,
                      args.process_id, device=device)


@contextlib.contextmanager
def process_group(args, device="cuda"):
    """The body of a CLI's ``main``: joins the group the add_cli_args flags
    describe (if any), yields this process's device, and leaves the group
    at the end."""
    joined = initialize_from_args(args, device)
    try:
        yield process_device(device)
    finally:
        if joined:
            shutdown()


def process_device(device="cuda") -> torch.device:
    """The device of this process: ``cuda:<local rank>`` for a CUDA device
    in a process group, else ``device`` itself."""
    device = torch.device(device)
    if device.type == "cuda" and dist.is_initialized():
        return torch.device("cuda", local_rank())
    return device


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def sync_hosts() -> None:
    """A barrier over every process (no-op for one process)."""
    if process_count() > 1:
        dist.barrier()
