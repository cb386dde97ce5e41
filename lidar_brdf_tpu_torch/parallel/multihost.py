"""Multi-process execution support (counterpart of
`lidar_brdf_tpu/parallel/multihost.py`).

One process per rank on `torch.distributed`: each rank generates only its
own contiguous range of pulses (`process_pulse_range`), runs it on its own
device (`shard.ray_mesh`) and writes its own point-cloud shard
(`write_host_shard`); only the gradients of replicated parameters cross
ranks, inside `shard.sharded_train_step`.  Importing this module sets up
nothing: no CUDA context and no process group.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING

import torch
import torch.distributed as dist

from ..core.types import RayBundle, resolve_device

RAY_AXIS = "rays"     # the JAX mesh's axis name; ranks split the rays

if TYPE_CHECKING:
    from ..core.types import PointCloud
    from .shard import RayMesh


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           backend: str | None = None,
                           device="cuda") -> None:
    """`torch.distributed.init_process_group` with PyTorch's environment
    fallbacks (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    With no address given or set, returns without starting a group (a
    single process).

    ``backend`` defaults to ``nccl`` when ``device`` is ``cuda`` (the
    default; raises without a card) and to ``gloo`` otherwise.  ``nccl``
    takes one card per rank: it raises when this host's ranks
    (``LOCAL_WORLD_SIZE``, else the world size) outnumber its cards.
    Several ranks can share one card over ``gloo``, which carries CUDA
    tensors.
    """
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR")
        if addr is None:
            return
        init_method = f"tcp://{addr}:{os.environ['MASTER_PORT']}"
    world_size = int(os.environ["WORLD_SIZE"] if world_size is None
                     else world_size)
    rank = int(os.environ["RANK"] if rank is None else rank)
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs device='cuda', not "
                             f"{dev.type!r}")
        ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        cards = torch.cuda.device_count()
        if ranks_here > cards:
            raise RuntimeError(
                f"nccl takes one card per rank: {ranks_here} ranks on this "
                f"host, {cards} card(s); several ranks share a card over "
                f"backend='gloo'")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def local_rank() -> int:
    """This process's rank among its host's (``LOCAL_RANK``, else its
    global rank, else 0)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def global_ray_mesh(devices=None) -> RayMesh:
    """The world group with this rank's device (`shard.ray_mesh`).  The JAX
    package builds one mesh over every chip of the job; a rank here sees
    only the group and its own device."""
    from .shard import ray_mesh
    return ray_mesh(devices)


def pulse_range(total_pulses: int, n: int, i: int) -> tuple[int, int]:
    """[start, end) pulse range of rank ``i`` of ``n``: pulses are split
    contiguously, ceil(total / n) each."""
    per = -(-total_pulses // n)
    return i * per, min((i + 1) * per, total_pulses)


def process_pulse_range(total_pulses: int) -> tuple[int, int]:
    """[start, end) pulse range owned by this rank (`pulse_range` over the
    group); (0, total) without a process group."""
    if not dist.is_initialized():
        return 0, total_pulses
    return pulse_range(total_pulses, dist.get_world_size(), dist.get_rank())


def write_host_shard(path_prefix: str, cloud: PointCloud) -> str:
    """Write this rank's point-cloud shard, `<prefix>.part<rank>.ply`,
    through the port's `io/ply.py::write_ply`; returns the path."""
    from ..io.ply import write_ply
    rank = dist.get_rank() if dist.is_initialized() else 0
    path = f"{path_prefix}.part{rank}.ply"
    write_ply(path, cloud)
    return path


def host_local_rays(rays: RayBundle, total_pulses: int) -> RayBundle:
    """This rank's pulses of a whole scan's bundle."""
    lo, hi = process_pulse_range(total_pulses)
    return RayBundle(origin=rays.origin[lo:hi],
                     direction=rays.direction[lo:hi],
                     gps_time=rays.gps_time[lo:hi])


def global_rays(local_rays: RayBundle, mesh: RayMesh) -> RayBundle:
    """This rank's bundle on its device.  The JAX package assembles one
    global array sharded over the mesh; PyTorch has no such array, so each
    rank keeps its own pulses (what that global array holds on its
    chips)."""
    return local_rays.to(mesh.device)


def host_local_cloud(cloud: PointCloud) -> PointCloud:
    """This rank's rows of a sharded scan on the host: the rank's cloud as
    CPU tensors, ready for `write_host_shard`."""
    return cloud.to("cpu")
