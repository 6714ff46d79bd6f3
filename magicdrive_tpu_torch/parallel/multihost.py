"""Process-group utilities (counterpart of ``parallel/multihost.py``; the
reference's torch.distributed object gathers,
ref:perception/common/ddp_utils.py:5-16, used by distributed val-set
generation, ref:val_set_gen.py:149-160).

A process started as a rank of a distributed job carries the ``env://``
variables (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
``LOCAL_RANK``), as ``torchrun`` sets them; ``initialize_if_needed`` joins
the job's process group from them once. A process without them is a
single process: every function here is then a no-op or its one-process
answer, as the JAX package's are on one host.

Backends: ``nccl`` for a CUDA device, each rank on ``cuda:LOCAL_RANK``,
and ``gloo`` for the CPU. A caller may ask for ``gloo`` on CUDA devices,
which lets several ranks share a card (ranks then go round the visible
cards); NCCL with more ranks on a node than visible cards raises.

``COLLECTIVES`` counts the collective calls the port's data paths make
(the gradient all-reduce, the cross-view gather, the frame exchange and
the gather's adjoint), one per call.
"""
from __future__ import annotations

import os
from typing import Any, List, Optional, Union

import torch
import torch.distributed as dist

COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0}

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def launched() -> bool:
    """Whether this process was started as a rank of a distributed job
    (the ``env://`` variables are set)."""
    return all(k in os.environ for k in _ENV)


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (``jax.process_index()``); 0 alone."""
    return dist.get_rank() if initialized() else 0


def process_count() -> int:
    """The job's world size (``jax.process_count()``); 1 alone."""
    return dist.get_world_size() if initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", process_index()))


def initialize_if_needed(backend: Optional[str] = None,
                         device: Union[str, torch.device] = "cuda") -> bool:
    """Join the job's process group once, from the ``env://`` variables;
    a no-op in a process not started as a rank, or already in a group.
    ``backend`` defaults to ``nccl`` for a CUDA ``device`` and ``gloo``
    for the CPU; under NCCL the rank takes ``cuda:LOCAL_RANK`` as its
    current device. Returns whether a process group is up."""
    if initialized():
        return True
    if not launched():
        return False
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        count = torch.cuda.device_count()
        if local_rank() >= count:
            raise RuntimeError(
                f"nccl: local rank {local_rank()} but {count} visible CUDA "
                "card(s); NCCL takes one card a rank (backend='gloo' lets "
                "ranks share a card)")
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def backend() -> Optional[str]:
    """The process group's backend, None alone."""
    return dist.get_backend() if initialized() else None


def rank_device(device: Union[str, torch.device]) -> torch.device:
    """The device of this rank for ``device``: a CUDA device without an
    index becomes the rank's card, ``cuda:LOCAL_RANK`` (under gloo, ranks
    beyond the visible cards go round them); any other device as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None or not initialized():
        return dev
    count = torch.cuda.device_count()
    if backend() == "nccl" and local_rank() >= count:
        raise RuntimeError(f"nccl: local rank {local_rank()} but {count} "
                           "visible CUDA card(s)")
    return torch.device("cuda", local_rank() % max(count, 1))


def all_gather_objects(obj: Any) -> List[Any]:
    """A picklable object from every rank, in rank order; ``[obj]`` alone,
    without touching a device."""
    if process_count() == 1:
        return [obj]
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def shutdown() -> None:
    """Leave the process group, if this process is in one (at the end of
    an entry point's process)."""
    if initialized():
        dist.destroy_process_group()


def barrier(name: str = "barrier") -> None:
    """Every rank waits here for the others (accelerate's
    ``wait_for_everyone``, ref:base_runner.py:300); ``name`` labels the
    point in the JAX package's API and is not sent. A no-op alone."""
    del name
    if process_count() > 1:
        dist.barrier()
