"""Multi-process runtime: one torch.distributed rank a shard.

Counterpart of vsearch_tpu/parallel/distributed.py.  torchrun starts the
ranks:

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m vsearch_tpu_torch --usearch_global q.fa --db db.fa ...

Every rank runs the identical host program (the host replay of the
accept/reject walks is deterministic, so replicating it needs no
synchronization), while the device state -- the k-mer incidence of the
static and the growing index, each alignment batch's pairs -- is sharded
over the ranks, and every result the host walk reads is all-gathered to
every rank (parallel/mesh.py).  Only rank 0 writes output files, stdout
and stderr; the others write theirs to the null device, so their byte
streams, and with them the program's path, stay identical.

The process group follows torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT); without WORLD_SIZE above 1 nothing
changes and the single-process path runs.  A rank runs on cuda:LOCAL_RANK
(nccl) unless the caller names its device: the CPU (gloo), or one card
that several ranks share (then gloo, as nccl refuses two ranks on one
card).
"""

from __future__ import annotations

import atexit
import os
import sys
from typing import Optional

import torch

_initialized = False
# the rank's device while a process group of more than one rank is up
_device: Optional[torch.device] = None


def local_device(name: str, local_rank: int,
                 device_count: int) -> torch.device:
    """The device a rank runs on: ``name``, where a bare "cuda" means
    cuda:local_rank.  Raises when the card it names is not there."""
    dev = torch.device(name)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        dev = torch.device("cuda", local_rank)
    if dev.index >= device_count:
        raise RuntimeError("rank on %s, but the node has %d CUDA devices"
                           % (dev, device_count))
    return dev


def maybe_initialize(backend: Optional[str] = None,
                     device: Optional[str] = None) -> bool:
    """Start the process group from torchrun's environment (once; True
    when more than one rank runs).

    Must run before any device use: it selects the rank's device
    (``device``, else $VSEARCH_TPU_TORCH_DEVICE, else cuda:LOCAL_RANK)
    and makes it the thread's current CUDA device, which the kernels'
    launches follow (ops/cuda_lib.stream_ptr).  The backend follows the
    device, nccl on cuda and gloo on the CPU, unless ``backend`` names
    one."""
    global _initialized, _device
    if _initialized:
        return _device is not None
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        _initialized = True
        return False
    from .. import device as device_mod
    # no card and no request for the CPU: raises, before the group forms
    name = str(device_mod.select(device))
    dev = local_device(name, int(os.environ.get("LOCAL_RANK", "0")),
                       torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    import torch.distributed as dist
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method="env://", world_size=world,
        rank=int(os.environ["RANK"]))
    atexit.register(shutdown)
    _initialized = True
    _device = dev
    device_mod.select(str(dev))
    if dist.get_rank() != 0:
        # the replicated drivers narrate identically; rank 0 reports
        sys.stdout = open(os.devnull, "w")
        sys.stderr = open(os.devnull, "w")
    return True


def shutdown() -> None:
    """Tear the process group down (at exit; once).

    Destroying the group joins its backend's worker threads.  They must be
    gone before the interpreter finalizes: a gloo worker drops the tensors
    of a collective it ran after the collective has returned, which takes
    the GIL, and a thread that takes the GIL while Python finalizes is
    unwound through C++ and aborts the process ("terminate called without
    an active exception", the rank exits -6 and torchrun fails the launch).
    The group is destroyed only when nothing holds it any more, so no
    object of the port keeps it (parallel/mesh.Mesh takes the default
    group)."""
    global _device
    if _device is None:
        return
    _device = None
    import torch.distributed as dist
    dist.destroy_process_group()


def select_device(name: Optional[str] = None) -> torch.device:
    """An entry point's device: under a process group the rank's own,
    which maybe_initialize selected (raising when ``name`` names another
    device), else device.select(name)."""
    if _device is None:
        from .. import device as device_mod
        return device_mod.select(name)
    if name is not None:
        dev = torch.device(name)
        if dev.type != _device.type or dev.index not in (None,
                                                          _device.index):
            raise ValueError("this rank runs on %s, not %s"
                             % (_device, dev))
    return _device


def rank_device() -> Optional[torch.device]:
    """The rank's device while a process group runs, else None."""
    return _device


def process_index() -> int:
    if _device is None:
        return 0
    import torch.distributed as dist
    return dist.get_rank()


def is_output_process() -> bool:
    """Only rank 0 writes real output files and reports; the other
    replicated drivers write to the null device, so that their host state
    (byte counts, orderings) stays identical."""
    return process_index() == 0


def output_path(path: Optional[str]) -> Optional[str]:
    """The null device in place of ``path`` on ranks other than 0."""
    if path is None or is_output_process():
        return path
    return os.devnull
