"""Production mesh descriptions (counterpart of ``repro/launch/mesh.py``).

Single pod:  (16, 16)      axes ("data", "model")        = 256 devices
Multi-pod:   (2, 16, 16)   axes ("pod", "data", "model") = 512 devices

A :class:`Mesh` is a plain description, ``.shape`` (axis -> size) and
``.axis_names``, and touches no device: the dry-run counts a step for it on
``meta``. :meth:`Mesh.device_mesh` builds the
``torch.distributed.device_mesh.DeviceMesh`` it describes, and only inside a
process group of exactly its size. The federated ``workers`` of the paper
map to the ("pod", "data") axes: 16 workers single-pod, 32 multi-pod (one
model replica per data group).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def device_mesh(self, device_type: str = "cuda"):
        """The ``DeviceMesh`` of this shape and these axis names over the
        default process group's ranks; raises unless the group has exactly
        ``size`` ranks (a description of 256 devices does not fit one card)."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.size:
            raise RuntimeError(f"mesh {self.shape} needs a process group of {self.size} ranks, "
                               f"this one has {world}")
        return init_device_mesh(device_type, self.sizes, mesh_dim_names=self.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_hierarchical_mesh(workers: int = 4) -> Mesh:
    """256 devices as (wk, data, model) = (workers, 16 // workers, 16).

    MARINA-P workers live on the small ``wk`` axis; each worker's replica is
    additionally FSDP-sharded over ``data``, so replica residency drops by
    the data size and Theorem 2's omega from 15 to workers - 1."""
    if 16 % workers:
        raise ValueError(f"workers={workers} does not divide 16")
    return Mesh(("wk", "data", "model"), (workers, 16 // workers, 16))


def worker_axes(mesh) -> tuple:
    """Mesh axes that enumerate federated workers."""
    if "wk" in mesh.axis_names:
        return ("wk",)
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def n_workers(mesh) -> int:
    n = 1
    for a in worker_axes(mesh):
        n *= mesh.shape[a]
    return n


def make_worker_mesh(n: int = 0) -> Mesh:
    """1-D ``workers`` mesh for the core-algorithm SPMD runner
    (``core/distributed.py``): ``n`` ranks, or every rank of the default
    process group; ``.device_mesh(...).get_group()`` is the group it takes."""
    if not n:
        import torch.distributed as dist

        n = dist.get_world_size()
    return Mesh(("workers",), (n,))
