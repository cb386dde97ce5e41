"""Multi-GPU execution: rays sharded over ranks (counterpart of
`lidar_brdf_tpu/parallel/shard.py`).

The JAX package shards pulses over a 1-D ``rays`` mesh with `shard_map`.
Here each rank is one process on `torch.distributed` that owns a contiguous
range of pulses and one device (`ray_mesh`); scene, BVH and materials are
replicated (every rank holds its own copy); a training step sums the local
losses and the gradients of the replicated parameters (material leaves,
vertices) with `all_reduce`, while origin gradients stay with their rank.

What `shard_map` needs and a process per rank does not: one shape on every
device, for which the JAX package stacks the shards' traverse data on a
device axis, padded to the union of their ladders (a dummy tile
``n_tiles``, pad rows with pulse id ``per``).  Here each rank holds exactly
what the single-device ``prepare`` gives on its own pulses.

Properties of the reference that the port keeps:

* noise per shard: each shard runs `simulate_chunk` with ``base_ray_index``
  0, so every shard draws its noise from ray index 0, not from its global
  offset (JAX `shard.py:142-146`);
* two ``t_max`` rules: the tile path resolves it per shard (the cull of the
  shard's own rays, `TileTraverser.prepare`), the ladder path over every
  rank's pulses (`PulseLadderTraverser.prepare_sharded`, a MAX over ranks);
* the face-pack gate ``F <= P * L`` sees the rank's own ``P``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..core.config import SensorConfig
from ..core.types import MaterialTable, RayBundle, resolve_device
from ..kernels.pulse import PulseLadders
from ..runtime.simulate import simulate_chunk
from . import multihost


@dataclass(frozen=True)
class RayMesh:
    """One rank's view of the ray mesh: its process group (None without
    one), rank, world size and device.  Without a group no collective runs:
    a single process, or one shard computed alone (``RayMesh(None, k, n,
    device)``: its losses and gradients are shard k's own)."""

    group: object
    rank: int
    world_size: int
    device: torch.device

    def __post_init__(self):
        dev = torch.device(self.device)      # "cuda" is the current card
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        object.__setattr__(self, "device", dev)

    def all_reduce(self, tensor: torch.Tensor,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``tensor`` reduced in place over the group (and returned)."""
        if self.group is not None:
            dist.all_reduce(tensor, op=op, group=self.group)
        return tensor


def ray_mesh(devices=None) -> RayMesh:
    """The world group (if one is started) with this rank's device:
    ``cuda:(LOCAL_RANK % device_count)`` by default (raises without a
    card), else ``devices[LOCAL_RANK % len(devices)]`` of a device or a
    sequence of them (``"cpu"`` for the plain PyTorch path)."""
    if dist.is_initialized():
        group, rank, world = (dist.group.WORLD, dist.get_rank(),
                              dist.get_world_size())
    else:
        group, rank, world = None, 0, 1
    local = multihost.local_rank()
    if devices is None:
        resolve_device("cuda")
        device = torch.device("cuda", local % torch.cuda.device_count())
    else:
        if isinstance(devices, (str, torch.device)):
            devices = [devices]
        device = resolve_device(devices[local % len(devices)])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return RayMesh(group, rank, world, device)


def shard_rays(rays: RayBundle, mesh: RayMesh) -> RayBundle:
    """This rank's contiguous slice of a whole scan's pulses, on its
    device; raises when the pulses do not split evenly over the ranks."""
    P, n = rays.num_pulses, mesh.world_size
    if P % n:
        raise ValueError(f"{P} pulses not divisible by {n} ranks")
    per = P // n
    sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return RayBundle(origin=rays.origin[sl], direction=rays.direction[sl],
                     gps_time=rays.gps_time[sl]).to(mesh.device)


def replicate(tree, mesh: RayMesh):
    """A dataclass of tensors (or a tuple or list of them) on this rank's
    device.  Keep the BVH on the host, where the cull walks it."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate(x, mesh) for x in tree)
    return tree.to(mesh.device)


def build_sharded_buckets(traverser, bvh, rays: RayBundle,
                          t_max: float | None = None):
    """The host (tidx, cand) buckets of a tile traverser for this rank's
    ``rays`` (tile ids local to the shard), culled on the traverser's
    device; ``t_max`` None is resolved from the shard's own rays, as each
    JAX shard's cull resolves it."""
    return traverser.build_buckets(bvh, rays.origin, rays.direction,
                                   t_max=t_max)


def build_sharded_traverse_data(traverser, bvh, rays: RayBundle,
                                mesh: RayMesh, t_max: float | None = None):
    """This rank's traverse data on the traverser's device, culled there
    (K5): the ladders of ``prepare_sharded`` for a traverser that has it
    (`PulseLadderTraverser`), else the tile buckets and bounds of its
    ``prepare`` (`TileTraverser`; ``t_max`` None is resolved from the
    shard's own rays)."""
    if hasattr(traverser, "prepare_sharded"):
        return traverser.prepare_sharded(bvh, rays.origin, rays.direction,
                                         mesh, t_max=t_max)
    return traverser.prepare(bvh, rays.origin, rays.direction, t_max=t_max)


def shard_traverse_data(data, mesh: RayMesh):
    """Traverse data (a tuple of tensor tuples, or `PulseLadders`) on this
    rank's device."""
    moved = tuple(tuple(a.to(mesh.device) for a in bucket)
                  for bucket in data)
    if isinstance(data, PulseLadders):
        return PulseLadders(moved, data.uncovered)
    return moved


# the JAX package's name for the same step: tile buckets are one instance
# of traverse data
shard_buckets_put = shard_traverse_data


def _check_rays(rays: RayBundle, mesh: RayMesh):
    if rays.origin.device != mesh.device:
        raise ValueError(f"rays on {rays.origin.device}, the rank's device "
                         f"is {mesh.device}")


def sharded_forward(mesh: RayMesh, cfg: SensorConfig, *,
                    scene_has_water=False, traverse_fn=None, packet_fn=None):
    """``fwd(scene, materials, rays, noise_buf, scalars,
    traverse_data=None)``: `simulate_chunk` on this rank's rays (from noise
    index 0) -> this rank's PointCloud.  ``traverse_fn``, ``packet_fn`` as
    in `simulate_chunk` (no traverser: the packet walk)."""

    def fwd(scene, materials, rays, noise_buf, scalars, traverse_data=None):
        _check_rays(rays, mesh)
        with torch.no_grad():
            return simulate_chunk(scene, materials, rays, noise_buf, scalars,
                                  cfg, scene_has_water=scene_has_water,
                                  traverse_fn=traverse_fn,
                                  traverse_data=traverse_data,
                                  packet_fn=packet_fn)

    return fwd


def _float_leaves(materials: MaterialTable) -> tuple:
    return (materials.refractive_index, materials.roughness,
            materials.brdf_table, materials.reflectivity_f0)


def _with_float_leaves(materials: MaterialTable, leaves) -> MaterialTable:
    ri, rough, table, f0 = leaves
    return MaterialTable(refractive_index=ri, roughness=rough,
                         brdf_table=table, brdf_model=materials.brdf_model,
                         reflectivity_f0=f0)


def sharded_train_step(mesh: RayMesh, cfg: SensorConfig, *,
                       scene_has_water=False, traverse_fn=None,
                       packet_fn=None, learning_rate=1e-3,
                       grad_params: str = "materials"):
    """``step(scene, materials, rays, noise_buf, scalars, target,
    traverse_data=None) -> (loss, updated_materials, grads)``: forward +
    backward on this rank's rays.

    Loss: L2 between the masked simulated intensity and ``target`` (this
    rank's rows), summed over the ranks by ``all_reduce``.  After the
    backward each replicated gradient (each material float leaf, and the
    vertex gradient) is summed by its own ``all_reduce``; origin gradients
    stay with their rank.  Every rank then applies the same update
    ``p - learning_rate * g`` to the material leaves.

    ``grad_params``: ``"materials"`` returns the material gradients (n(λ),
    roughness, BRDF table, f0) as a tuple; ``"full"`` returns
    ``{"materials": ..., "vertices": ..., "origin": ...}``.
    """
    if grad_params not in ("materials", "full"):
        raise ValueError(f"grad_params must be 'materials' or 'full', not "
                         f"{grad_params!r}")
    full = grad_params == "full"

    def step(scene, materials, rays, noise_buf, scalars, target,
             traverse_data=None):
        _check_rays(rays, mesh)
        leaves = tuple(p.detach().requires_grad_()
                       for p in _float_leaves(materials))
        params = list(leaves)
        if full:
            verts = scene.vertices.detach().requires_grad_()
            origin = rays.origin.detach().requires_grad_()
            scene = dataclasses.replace(scene, vertices=verts)
            rays = RayBundle(origin=origin, direction=rays.direction,
                             gps_time=rays.gps_time)
            params += [verts, origin]
        cloud = simulate_chunk(scene, _with_float_leaves(materials, leaves),
                               rays, noise_buf, scalars, cfg,
                               scene_has_water=scene_has_water,
                               traverse_fn=traverse_fn,
                               traverse_data=traverse_data,
                               packet_fn=packet_fn)
        pred = torch.where(cloud.mask, cloud.intensity,
                           torch.zeros_like(cloud.intensity))
        local_loss = ((pred - target) ** 2).sum()
        grads = torch.autograd.grad(local_loss, params, allow_unused=True)
        # the collectives take contiguous tensors only (an index backward
        # on the card can return a strided gradient)
        grads = [torch.zeros_like(p) if g is None else g.contiguous()
                 for p, g in zip(params, grads)]
        loss = mesh.all_reduce(local_loss.detach())
        for g in grads[:5]:            # material leaves, vertices
            mesh.all_reduce(g)
        new = tuple(p.detach() - learning_rate * g
                    for p, g in zip(leaves, grads))
        new_materials = _with_float_leaves(materials, new)
        if full:
            return loss, new_materials, {"materials": tuple(grads[:4]),
                                         "vertices": grads[4],
                                         "origin": grads[5]}
        return loss, new_materials, tuple(grads)

    return step
