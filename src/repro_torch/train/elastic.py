"""Elastic restart: node failure -> smaller mesh -> restore -> continue.

As in ``repro.train.elastic``: ``shrink_mesh`` rebuilds the largest
(data, model) mesh from the surviving devices with the model-axis width
kept, and ``resume`` restores the latest checkpoint onto the new mesh
(the checkpoint stores full logical arrays), from the same step; the
counter-based token stream replays the exact batch sequence.  On a
distributed mesh each rank keeps its shards under the new mesh's
specs.  The survivors form a new ``torch.distributed`` world (a
relaunch on them), so ``shrink_mesh`` on a distributed world spans it.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.launch.mesh import Mesh, build_mesh
from repro_torch.models import params as pp
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import NamedSharding, P
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import RunConfig, param_shardings


def shrink_mesh(devices: Sequence[torch.device], model_parallel: int,
                *, axis_names=("data", "model")) -> Mesh:
    """Largest (data, model) mesh from surviving devices; TP width fixed."""
    n = len(devices)
    if n < model_parallel:
        raise RuntimeError(
            f"only {n} devices survive; cannot keep TP={model_parallel}")
    data = n // model_parallel
    return build_mesh(axis_names, (data, model_parallel),
                      devices[: data * model_parallel])


def resume(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, ckpt_dir: str,
           new_mesh: Mesh, run: RunConfig = RunConfig()):
    """(params, opt_state, step) of the latest checkpoint re-sharded for
    ``new_mesh`` (this rank's shards on a distributed mesh)."""
    step = ckpt.latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    p_shard = param_shardings(cfg, new_mesh, run)
    abstract = {"params": pp.abstract_params(cfg)}
    abstract["opt"] = adamw.abstract_state(abstract["params"])
    shardings = None
    if new_mesh.distributed:
        shardings = {"params": p_shard,
                     "opt": adamw.AdamWState(
                         step=NamedSharding(new_mesh, P()), m=p_shard,
                         v=p_shard)}
    state, step = ckpt.restore(ckpt_dir, step, abstract, shardings,
                               device=new_mesh.local_device)
    return state["params"], state["opt"], step
