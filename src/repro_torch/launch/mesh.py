"""Device meshes: a named grid of devices, one process per device.

A ``Mesh`` holds axis names, their sizes and the devices in row-major
order.  It comes in three forms:

* **local**: no process group; one device (this process's), on which
  the steps run without collectives.  A local mesh of more than one
  device can be built (``elastic.shrink_mesh`` does) but nothing trains
  on it: the step factories raise rather than train on one of its
  devices.
* **distributed**: every rank of the ``torch.distributed`` world, one
  process per GPU (``torchrun``) or per CPU rank (gloo), laid out
  row-major over the axes.  It is backed by a
  ``torch.distributed.device_mesh.DeviceMesh`` (one process group per
  axis) and holds a process group for every set of two or more axes
  (the batch axes ("pod", "data"), the whole mesh).
* **abstract**: names and sizes only, no devices and no process group
  (``make_production_mesh``), for the spec functions and the dry run.

Meshes are built by functions, so importing this module touches no
device state.  Every rank must build a distributed mesh, in the same
order: process groups are created collectively.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels.ops import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]
    #: the global rank of each device, row-major; None for a local or an
    #: abstract mesh
    ranks: Optional[Tuple[int, ...]] = None
    device_mesh: Any = None
    groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes) or \
                (self.devices and self.size != len(self.devices)):
            raise ValueError(f"axes {self.axis_names} of sizes "
                             f"{self.axis_sizes} for {len(self.devices)} "
                             f"devices")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    @property
    def distributed(self) -> bool:
        return self.ranks is not None

    @property
    def abstract(self) -> bool:
        return not self.devices

    def _index(self) -> int:
        if not self.distributed:
            return 0
        import torch.distributed as dist
        return self.ranks.index(dist.get_rank())

    @property
    def local_device(self) -> torch.device:
        """The device this process computes on."""
        if self.abstract:
            raise ValueError("an abstract mesh has no devices")
        return self.devices[self._index()]

    def coordinate(self, axis: str) -> int:
        """This process's coordinate along ``axis`` (0 on a local mesh)."""
        i, coord = self._index(), {}
        for name, size in reversed(list(zip(self.axis_names,
                                            self.axis_sizes))):
            coord[name] = i % size
            i //= size
        return coord[axis]

    def group(self, axes: Tuple[str, ...]):
        """The process group over ``axes`` (in mesh order) that holds this
        process; ranks in it are ordered row-major over those axes."""
        axes = tuple(a for a in self.axis_names if a in axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self.groups[axes]


def distributed_mesh(axis_names, axis_sizes, devices) -> Mesh:
    """A mesh over the whole ``torch.distributed`` world: rank r computes
    on ``devices[r]``.  Collective: every rank calls it, in the same
    order."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    axis_names, axis_sizes = tuple(axis_names), tuple(axis_sizes)
    devices = tuple(devices)
    if len(devices) != world:
        raise ValueError(f"a mesh over {len(devices)} devices in a world of "
                         f"{world} ranks: relaunch on the devices to keep")
    ranks = tuple(range(world))
    grid = torch.arange(world).reshape(axis_sizes)
    dm = DeviceMesh(devices[dist.get_rank()].type, grid,
                    mesh_dim_names=axis_names)
    groups = {}
    me = dist.get_rank()
    for n in range(2, len(axis_names) + 1):
        for axes in itertools.combinations(axis_names, n):
            keep = [axis_names.index(a) for a in axes]
            rest = [i for i in range(len(axis_names)) if i not in keep]
            members = grid.permute(*rest, *keep).reshape(
                -1, int(torch.tensor([axis_sizes[i] for i in keep]).prod()))
            for row in members.tolist():
                g = dist.new_group(row)
                if me in row:
                    groups[axes] = g
    return Mesh(axis_names, axis_sizes, devices, ranks, dm, groups)


def build_mesh(axis_names, axis_sizes, devices) -> Mesh:
    """A distributed mesh when a process group is up, a local one
    otherwise."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return distributed_mesh(axis_names, axis_sizes, devices)
    return Mesh(tuple(axis_names), tuple(axis_sizes), tuple(devices))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh as an abstract mesh: 16x16 on
    ("data", "model"), or 2x16x16 with "pod" (which carries only data
    parallel traffic: the gradient sum across pods)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape, ())


def world_devices(device) -> Tuple[torch.device, ...]:
    """Each rank's device: for CUDA, rank r's is ``cuda:(r % local
    count)`` (one process per GPU, ``LOCAL_RANK`` order); all "cpu" for
    the CPU."""
    import torch.distributed as dist
    world = dist.get_world_size()
    if device.type == "cuda":
        n = torch.cuda.device_count()
        return tuple(torch.device("cuda", r % n) for r in range(world))
    return (device,) * world


def init_distributed(device="cuda") -> bool:
    """Bring up the default process group from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``PORT``): NCCL on CUDA,
    gloo on the CPU, and select ``LOCAL_RANK``'s GPU.  Returns whether a
    group is up; without that environment, and where a group is already
    up, it starts none."""
    import torch.distributed as dist
    dev = resolve_device(device)
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://")
    return True


def make_host_mesh(model_parallel: int | None = None, *,
                   device="cuda") -> Mesh:
    """A ("data", "model") mesh; the model axis is 2 wide where the count
    is even and above 1, as in the reference.  With a process group up
    it spans the world (one rank a device); without one it holds this
    process's one device, CUDA unless ``device="cpu"``, and raises where
    more than one GPU is visible (start one process per GPU under
    ``torchrun``)."""
    import torch.distributed as dist
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        devices = world_devices(dev)
    elif dev.type == "cuda":
        n = torch.cuda.device_count()
        if n > 1:
            raise RuntimeError(
                f"{n} CUDA devices and no process group: start one process "
                f"per GPU under torchrun")
        devices = (torch.device("cuda", 0),)
    else:
        devices = (dev,)
    n = len(devices)
    mp = model_parallel or (2 if n % 2 == 0 and n > 1 else 1)
    if n % mp:
        raise ValueError(f"model axis {mp} does not divide {n} devices")
    return build_mesh(("data", "model"), (n // mp, mp), devices)
