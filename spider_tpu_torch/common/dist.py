"""Distributed bootstrap over ``torch.distributed`` (counterpart of
spider_tpu/common/dist.py).

Where the JAX package has ``jax.distributed.initialize`` and a named
``jax.sharding.Mesh``, the port has ``torch.distributed.init_process_group``
and a ``DeviceMesh`` with the same five axis names, (data, fsdp, model,
expert, context), data outermost. A mesh is laid over RANKS, one device each:
``cuda:LOCAL_RANK`` with the ``nccl`` backend, or the CPU with ``gloo`` when
the caller asks for it (the tests do).

``init_distributed_mode`` reads the rendezvous from torchrun's environment
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) or from explicit
arguments; a process given neither starts a world of one on 127.0.0.1 at a
free port, so one card runs the same code as many.
"""

from __future__ import annotations

import datetime
import functools
import logging
import os
import socket
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_MODEL = "model"
AXIS_EXPERT = "expert"
AXIS_CONTEXT = "context"
AXES = (AXIS_DATA, AXIS_FSDP, AXIS_MODEL, AXIS_EXPERT, AXIS_CONTEXT)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed_mode(device: Union[str, torch.device, None] = None, *,
                          init_method: Optional[str] = None,
                          world_size: Optional[int] = None, rank: Optional[int] = None,
                          timeout_s: float = 600.0) -> torch.device:
    """Join (or start) the process group; returns this rank's device.

    device: "cpu" takes the ``gloo`` backend; None or a CUDA device takes
    ``nccl`` on ``cuda:LOCAL_RANK`` (or the index given), and raises where
    there is no CUDA device: there is no fallback to the CPU. world_size and
    rank default to torchrun's WORLD_SIZE and RANK, else a world of one;
    init_method defaults to ``env://`` when MASTER_ADDR is set, else
    ``tcp://127.0.0.1:<free port>`` (a world of one only). Safe to call
    again: a second call returns the device of the first."""
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed_mode: no CUDA device; pass device='cpu' for "
                               "the gloo backend")
        index = torch.device(device).index if device is not None else None
        if index is None:
            index = int(os.environ.get("LOCAL_RANK", 0))
        device, backend = torch.device("cuda", index), "nccl"
        torch.cuda.set_device(device)
    elif torch.device(device).type == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"init_distributed_mode runs on cpu or cuda, got {device}")
    if dist.is_initialized():
        return device
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif world_size == 1:
            init_method = f"tcp://127.0.0.1:{free_port()}"
        else:
            raise ValueError("a world of more than one rank needs an init_method or "
                             "torchrun's MASTER_ADDR and MASTER_PORT")
    kwargs = dict(device_id=device) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
                            **kwargs)
    setup_for_distributed(is_main_process())
    return device


def destroy() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_dist_avail_and_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if is_dist_avail_and_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_dist_avail_and_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def main_process(func):
    """Decorator: run only on rank 0 (elsewhere return None)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if is_main_process():
            return func(*args, **kwargs)
        return None

    return wrapper


def setup_for_distributed(is_master: bool) -> None:
    """Quiet the root logger below WARNING on every rank but 0."""
    if not is_master:
        logging.getLogger().setLevel(logging.WARNING)


def barrier() -> None:
    if is_dist_avail_and_initialized():
        dist.barrier()


def _factorize(n: int, shape: Sequence[Optional[int]]) -> Tuple[int, ...]:
    """Fill at most one -1/None entry of `shape` so the product equals n
    ranks (the JAX package counts devices; its errors are these)."""
    known = 1
    free = None
    out = list(shape)
    for i, s in enumerate(out):
        if s in (None, -1):
            if free is not None:
                raise ValueError("at most one mesh axis may be -1")
            free = i
        else:
            known *= s
    if free is not None:
        if n % known:
            raise ValueError(f"cannot factor {n} ranks into {shape}")
        out[free] = n // known
        known = n
    if known != n:
        raise ValueError(f"mesh shape {out} != rank count {n}")
    return tuple(out)


def mesh_shape(data: Optional[int] = None, fsdp: int = 1, model: int = 1, expert: int = 1,
               context: int = 1, *, world_size: Optional[int] = None) -> Tuple[int, ...]:
    """The (data, fsdp, model, expert, context) sizes over `world_size`
    ranks (the process group's by default); raises ValueError where the
    world cannot hold them exactly."""
    n = get_world_size() if world_size is None else world_size
    return _factorize(n, [data, fsdp, model, expert, context])


def make_mesh(data: Optional[int] = None, fsdp: int = 1, model: int = 1, expert: int = 1,
              context: int = 1):
    """The global ``DeviceMesh`` over the initialised process group, with
    dimensions (data, fsdp, model, expert, context): data outermost, so
    consecutive ranks share the inner axes. The device type follows the
    backend (``cuda`` for nccl, ``cpu`` for gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not is_dist_avail_and_initialized():
        raise RuntimeError("make_mesh needs the process group: call init_distributed_mode")
    shape = mesh_shape(data, fsdp, model, expert, context)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


VIDEO_AXES = ("cfg", "sp")


def make_video_mesh(cfg: int = 1, sp: Optional[int] = None):
    """The ``DeviceMesh`` of the sharded video denoise
    (``TextToVideoSDPipeline.__call__(mesh=)``), dimensions (cfg, sp), cfg
    outermost: the CFG pair split over ``cfg``, the frames over ``sp``. sp
    None takes the ranks cfg leaves; raises ValueError where the world
    cannot hold the shape exactly."""
    from torch.distributed.device_mesh import init_device_mesh

    if not is_dist_avail_and_initialized():
        raise RuntimeError("make_video_mesh needs the process group: call init_distributed_mode")
    shape = _factorize(get_world_size(), [cfg, sp])
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=VIDEO_AXES)


def default_mesh():
    """Every rank on the data axis (pure data parallelism)."""
    return make_mesh(data=None)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(AXES.index(axis)) if mesh is not None else 1


def data_parallel_rank(mesh) -> Tuple[int, int]:
    """(rank, size) over data x fsdp: the index of the batch this rank
    draws. Ranks that differ only in model, expert or context share it
    (context peers hold pieces of the same sequences)."""
    if mesh is None:
        return 0, 1
    coord = mesh.get_coordinate()
    fsdp = axis_size(mesh, AXIS_FSDP)
    return (coord[AXES.index(AXIS_DATA)] * fsdp + coord[AXES.index(AXIS_FSDP)],
            axis_size(mesh, AXIS_DATA) * fsdp)


def context_rank(mesh) -> Tuple[int, int]:
    """(rank, size) over the context axis."""
    if mesh is None:
        return 0, 1
    return mesh.get_coordinate()[AXES.index(AXIS_CONTEXT)], axis_size(mesh, AXIS_CONTEXT)
