"""Host meshes: a named grid of ``torch.device``s.

A ``Mesh`` is a plain value (axis names, their sizes, the devices in
row-major order), built by a function so that importing this module
touches no device state.  ``make_host_mesh`` applies the reference's
arithmetic (``repro.launch.mesh``) to ``torch.cuda.device_count()``, or
to one CPU when asked.  The reference's ``auto_axis_types`` only papers
over JAX versions and has no counterpart; ``make_production_mesh`` (the
256- and 512-chip meshes) comes with sharded training.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.kernels.ops import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        n = 1
        for s in self.axis_sizes:
            n *= s
        if len(self.axis_names) != len(self.axis_sizes) or \
                n != len(self.devices):
            raise ValueError(f"axes {self.axis_names} of sizes "
                             f"{self.axis_sizes} for {len(self.devices)} "
                             f"devices")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)


def make_host_mesh(model_parallel: int | None = None, *,
                   device="cuda") -> Mesh:
    """A ("data", "model") mesh over every CUDA device (one CPU with
    ``device="cpu"``); the model axis is 2 wide where the count is even
    and above 1, as in the reference."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    n = len(devices)
    mp = model_parallel or (2 if n % 2 == 0 and n > 1 else 1)
    return Mesh(("data", "model"), (n // mp, mp), tuple(devices))
