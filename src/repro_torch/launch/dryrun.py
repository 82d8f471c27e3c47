"""Dry run: the per-device account of every (arch x shape x mesh) cell.

The reference lowers and compiles each cell on 512 fake devices and mines
XLA's ``memory_analysis()``, ``cost_analysis()`` and the HLO's
collectives.  The port has no compiler to ask, so it does the accounting
itself on ``meta`` tensors (``abstract_params``, ``abstract_state``,
``input_specs``, ``abstract_cache``): bytes a device from the spec trees
of ``train/loop.py``, FLOPs from ``model_flops``, and collective bytes
from how the port's sharded steps run, read under the same placement
the steps build (``model._kept``, the MoE buffers' resolved spec): per
step, the output bytes of each collective, as the reference counts the
HLO's.  ``tests/test_torch_mesh_train.py`` holds these to the bytes a
(2, 2) gloo run sends in a train, prefill and decode step.

* ``all-gather``: each sharded parameter where it runs, one gather a
  split dim (a stacked unit's again in the remat recompute, every leaf
  once a micro-batch); the MoE's tokens over the batch axes, its
  experts' outputs over "model" (or capacity slots over "data"), and in
  training its inputs' gradient over "model" (and, expert parallel with
  the expert weights gathered whole, theirs); in decode every head's q,
  k and v and the recurrent states split over "model"; the serving
  logits over the batch axes;
* ``reduce-scatter``: each gradient summed over a batch axis its
  parameter is sharded on (float32); the MoE tokens' and capacity
  slots' gradients;
* ``all-reduce``: each gradient summed over the batch axes its parameter
  is not sharded on, the "pod" axis included (the data-parallel sum);
  the tensor-parallel sums; decode attention's sums over the positions
  split over "model"; the loss's scalars and the global norm's sums.

Tensor parallelism splits the products of attention, dense FFNs and
shared experts over "model" where it divides their heads or widths
(``model.tp_split``; in decode too, the heads gathered for the cache):
a device's FLOPs are ``model_flops`` over the batch shards, less the
split layers' share over "model", and each split layer adds a float32
all-reduce of its activations forward (and in the recompute, but for a
unit's closing one, which the recompute stops short of) and of their
gradient backward.  The rest (embedding, head, recurrent blocks, routed
experts but for expert parallelism) is replicated over "model".
H100 constants replace the reference's v5e ones.

Fields of the reference's cell that only XLA can give, and the port does
not report: ``hlo_flops_per_chip``, ``hlo_bytes_per_chip``,
``useful_flops_ratio``, ``bytes_per_device.temp`` and ``.peak`` (XLA's
temporaries), ``compile_s`` and ``cost_pass``'s unrolled extrapolation.
The port reports ``flops_per_device``, ``memory_bytes_per_device`` (a
lower bound: weights read per pass, the optimizer's bytes, the caches),
``collective_bytes_per_device``, ``bytes_per_device`` (params, opt_state,
grads, accumulators, inputs, caches, argument) and ``account_s``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun               # all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma_7b \\
        --shape train_4k --multi-pod both --json out.json
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, input_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as mm
from repro_torch.models import params as pp
from repro_torch.models import sharding as sh
from repro_torch.models.config import SHAPES, shape_applicable
from repro_torch.models.moe import _capacity
from repro_torch.models.sharding import entry_axes, shard_shape, spec_leaves
from repro_torch.optim import adamw
from repro_torch.train import loop

#: NVIDIA H100 SXM5, per GPU (data sheet): dense bf16 tensor-core FLOP/s
#: and HBM3 bytes/s.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
#: NVLink 4 (data sheet: 900 GB/s bidirectional a GPU, 18 links), one
#: direction.  A mesh of more than 8 GPUs crosses InfiniBand (NDR, 50 GB/s
#: a GPU), which this single rate does not model.
LINK_BW = 450e9
#: Bytes of optimizer traffic a parameter: read p, g, m, v, write p, m, v,
#: and the gradient norm's read of g.
OPT_BYTES = 2 + 2 + 4 + 4 + 2 + 4 + 4 + 2


def model_flops(cfg, shape) -> float:
    """6*N*D train / 2*N_active*D inference (decode: D = new tokens)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch       # one token per stream


def _n_units(cfg) -> int:
    return (cfg.num_layers - cfg.dense_first_layers) // len(cfg.pattern())


def _partial_unroll(cfg) -> int:
    """Largest small divisor of the unit count (the reference's partial
    unroll of its layer scan)."""
    n = _n_units(cfg)
    for u in (4, 3, 2):
        if n % u == 0 and n > u:
            return u
    return 1


def run_config(cfg, shape) -> loop.RunConfig:
    """The reference's choice for a cell: FSDP for archs over 8 B
    parameters (for decode, only where the TP-sharded weights pass 10 GB),
    8 micro-batches a train step."""
    fsdp = cfg.param_count() > 8e9
    if shape.kind == "decode":
        fsdp = cfg.param_count() * 2 / 16 > 10e9
    return loop.RunConfig(fsdp=fsdp, remat=True, donate=True,
                          grad_accum=8 if shape.kind == "train" else 1)


def _layer_kinds(cfg) -> list:
    """The block kind of every layer: prefix, stacked units, tail."""
    unit = cfg.pattern()
    n_scan = cfg.num_layers - cfg.dense_first_layers
    return [unit[0]] * cfg.dense_first_layers + \
        list(unit) * (n_scan // len(unit)) + list(unit[: n_scan % len(unit)])


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _gathered(shape, spec, ms, kept_axis=None) -> int:
    """Elements out of ``Placement.gather_param`` of a leaf: an all-gather
    a split dim, in order, each making its dim whole (a kept leaf's dims
    split over ``kept_axis`` only stay split)."""
    cur = list(shard_shape(shape, spec, ms))
    n = 0
    for d, e in enumerate(spec):
        ax = entry_axes(e)
        if ax and not set(ax) <= {kept_axis}:
            cur[d] = shape[d]
            n += _numel(cur)
    return n


def _grad_sums(shape, spec, ms, batch) -> tuple:
    """(reduce-scatter, all-reduce) float32 elements of a gathered leaf's
    backward (``_GatherParam``): a reduce-scatter a dim split over the
    batch axes (``batch``: those the batch is split over), then one
    all-reduce over the rest of them."""
    cur = list(shard_shape(shape, [e if set(entry_axes(e)) - set(batch)
                                   else None for e in spec], ms))
    rs, summed = 0, set()
    for d, e in enumerate(spec):
        ax = entry_axes(e)
        if ax and set(ax) <= set(batch):
            cur[d] = shape[d] // _numel(ms[a] for a in ax)
            rs += _numel(cur)
            summed |= set(ax)
    rest = [a for a in batch if a not in summed]
    return rs, _numel(cur) if rest else 0


def _blocks(params, specs):
    """(group, block, its unstacked view, the view's specs, layers, kind)
    of every block of the stack, in run order."""
    for group in ("prefix", "stack", "tail"):
        for name, block in params[group].items():
            view, bs, n = block, specs[group][name], 1
            if group == "stack":
                n = next(iter(block.values())).shape[0]
                view = {k: v[0] for k, v in block.items()}
                bs = {k: v[1:] for k, v in bs.items()}
            yield group, block, view, bs, n, name.split("_", 1)[1]


def _closing_sum(block, sums) -> bool:
    """Whether a block's last op is a tensor-parallel sum (``sums``: the
    split products' first weights)."""
    if "router" in block:
        return "s_gate" in sums
    if "w_gate" in block:
        return "w_gate" in sums
    return "wq" in sums


def _collectives(cfg, shape, mesh, run, params, specs, place) -> tuple:
    """(bytes by kind, the leaves kept over "model", the tensor-parallel
    layers) of one step's collectives on ``mesh``, as the port's sharded
    steps send them under ``place``: the model's own choices (``_kept``,
    the MoE buffers' constraint) read under the placement.  The output
    bytes of each collective, as the reference counts the HLO's."""
    ms, B = mesh.shape, shape.global_batch
    train, decode = shape.kind == "train", shape.kind == "decode"
    micro = run.grad_accum if train else 1
    passes = 2 if train and run.remat else 1
    seq = 1 if decode else shape.seq_len
    batch = place.batch_axes if place.batch_sharded else ()
    rows = B // micro // place.batch_parts        # a micro-batch's, a rank
    d = cfg.d_model
    coll = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    kept_ids, tp_layers = set(), 0
    # the embedding, the final norm and the head: gathered once a pass
    for k in ("embed", "final_norm", "lm_head"):
        if k in params:
            t = params[k]
            coll["all-gather"] += micro * t.element_size() * \
                _gathered(t.shape, specs[k], ms)
    blocks = list(_blocks(params, specs))
    for i, (group, stored, block, bs, n, kind) in enumerate(blocks):
        with sh.use(place):
            kept = mm._kept(cfg, place, kind, block, bs)
        kept_ids |= {id(stored[k]) for k in kept}
        again = passes if group == "stack" else 1
        for k, t in block.items():
            coll["all-gather"] += n * micro * again * t.element_size() * \
                _gathered(t.shape, bs[k], ms,
                          place.tp_axis if k in kept else None)
        act = n * micro * rows * seq * d * 4
        sums = [k for k in ("wq", "w_gate", "s_gate") if k in kept and
                not (k == "w_gate" and "router" in block)]
        tp_layers += n * len(sums)
        if sums:
            # the recompute stops once the backward has what it needs: a
            # unit's closing tensor-parallel sum is not run again
            last = i + 1 == len(blocks) or blocks[i + 1][0] != "stack"
            closing = again > 1 and group == "stack" and last and \
                _closing_sum(block, sums)
            coll["all-reduce"] += act * (len(sums) * again - closing)
            if train:
                coll["all-reduce"] += act * len(sums)
                if cfg.qk_norm and "wq" in sums:
                    coll["all-reduce"] += n * micro * 2 * cfg.head_dim * 4
            if decode and "wq" in sums:
                # every head's q, k and v for the cache
                coll["all-gather"] += n * rows * (
                    cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim * 2
        if "router" in block:
            _moe_collectives(cfg, block, kept, n * micro, again, train,
                             B // micro * seq, place, coll)
    if train:
        for t, s in zip(pp.tree_leaves(params), spec_leaves(specs)):
            rs, ar = _grad_sums(t.shape, s, ms, batch)
            coll["reduce-scatter"] += micro * 4 * rs
            coll["all-reduce"] += micro * 4 * ar
        # the loss's count a micro-batch, loss, ce and aux summed over the
        # batch shards; every leaf's sum of squares for the global norm
        if batch:
            coll["all-reduce"] += 4 * (micro + 3)
        coll["all-reduce"] += 4 * len(pp.tree_leaves(params))
    if decode and "model" in ms:
        # the max, the softmax's sum and the partial outputs (float32)
        # over the positions split over "model"; recurrent states split
        # over "model", gathered for the step
        kinds = _layer_kinds(cfg)
        attn = sum(1 for k in kinds if k in ("attn", "moe"))
        per_row = cfg.num_heads * (2 + cfg.head_dim) * 4
        coll["all-reduce"] += attn * rows * per_row
        for kind in set(kinds) - {"attn", "local_attn", "moe"}:
            block = mm._block_cache_shape(cfg, kind, B, shape.seq_len)
            for t, sp in zip(block, loop.block_cache_spec(cfg, mesh, B,
                                                          kind)):
                if "model" in [a for e in sp for a in entry_axes(e)]:
                    coll["all-gather"] += kinds.count(kind) * \
                        t.numel() * t.element_size() // place.batch_parts
    if not train and batch:
        # the whole batch's logits (float32), gathered
        coll["all-gather"] += B * cfg.vocab_size * cfg.num_codebooks * 4
    return coll, kept_ids, tp_layers


def _moe_collectives(cfg, block, kept, calls, again, train, tokens, place,
                     coll):
    """A routed MoE layer's collectives, ``calls`` times: the global token
    set gathered over the batch axes (its gradient reduce-scattered
    back), the (E, cap, d) buffers split as ``moe._expert_axes`` resolves
    them (the outputs gathered forward, the inputs' gradient gathered
    over "model" backward, the outputs' reduce-scattered over "data"),
    and, expert parallel with the expert weights gathered whole, their
    gradients gathered over "model"."""
    from repro_torch.models import moe
    ms, d = place.mesh.shape, cfg.d_model
    E = cfg.moe.num_experts * cfg.moe.expert_split
    if place.batch_sharded:
        coll["all-gather"] += calls * again * tokens * d * 2
        if train:
            coll["reduce-scatter"] += calls * tokens // \
                place.batch_parts * d * 4
    buf = (E, _capacity(tokens, cfg.moe), d)
    with sh.use(place):
        _, spec = mm._resolved(torch.empty(buf, device="meta"),
                               moe._expert_axes(E))
        whole = moe._ep_possible(E) and "w_gate" not in kept
    cur = list(shard_shape(buf, spec, ms))
    for dim, e in enumerate(spec):
        for a in entry_axes(e):
            before = _numel(cur)
            cur[dim] *= ms[a]
            coll["all-gather"] += calls * again * _numel(cur) * 2
            if not train:
                continue
            if a in place.batch_axes:
                coll["reduce-scatter"] += calls * before * 4
            else:
                coll["all-gather"] += calls * _numel(cur) * 2
    if train and whole:
        coll["all-gather"] += calls * sum(
            block[k].numel() * block[k].element_size() for k in
            ("w_gate", "w_up", "w_down"))


def account(cfg, shape, mesh, run: loop.RunConfig) -> Dict[str, Any]:
    """The per-device account of one cell on ``mesh`` (an abstract mesh,
    or any mesh: only its names and sizes are read)."""
    ms = mesh.shape
    chips = mesh.size
    B = shape.global_batch
    split = loop.batch_split(mesh, B)
    parts_b = loop.batch_parts(mesh) if split else 1
    specs = loop.param_specs_for(cfg, mesh, run)
    params = pp.abstract_params(cfg)
    leaves = pp.tree_leaves(params)
    p_specs = spec_leaves(specs)
    shard = [_numel(shard_shape(t.shape, s, ms)) for t, s in
             zip(leaves, p_specs)]
    p_bytes = sum(n * t.element_size() for n, t in zip(shard, leaves))
    micro = run.grad_accum if shape.kind == "train" else 1
    passes = 2 if shape.kind == "train" and run.remat else 1
    mp = ms.get(run.model_axis, 1)
    place = loop._placement(cfg, mesh, run, B)
    coll, kept, tp_layers = _collectives(cfg, shape, mesh, run, params,
                                         specs, place)
    # the kept leaves' products split over "model" (tensor and expert
    # parallelism)
    tp_names = set()
    for group in ("stack", "tail", "prefix"):
        for name, block in params[group].items():
            tp_names |= {id(block[k]) for k in mm.tp_split(
                cfg, name.split("_", 1)[1], block, mp)}
    tp_params = sum(t.numel() for t in leaves if id(t) in tp_names)
    read = sum(t.numel() * t.element_size() // (mp if id(t) in kept else 1)
               for t in leaves)
    out: Dict[str, Any] = {"chips": chips, "fsdp": run.fsdp,
                           "grad_accum": run.grad_accum,
                           "n_units": _n_units(cfg),
                           "batch_split": split, "tp_layers": tp_layers}
    by = {"params": p_bytes}
    inputs = input_specs(cfg, shape)
    dense = 1 - tp_params / cfg.active_param_count() * (1 - 1 / mp)
    if shape.kind == "train":
        state = adamw.abstract_state(params)
        by["opt_state"] = 2 * 4 * sum(shard) + \
            state.step.element_size()
        by["grads"] = p_bytes
        by["accumulators"] = 4 * sum(shard) if run.grad_accum > 1 else 0
        flops = model_flops(cfg, shape) / parts_b * dense
        # weights read forward, in the recompute and backward, a
        # micro-batch; the optimizer on this device's shards
        mem = micro * (passes + 1) * read + OPT_BYTES * sum(shard)
        inp = sum(t.numel() * t.element_size()
                  for t in pp.tree_leaves(inputs))
        by["inputs"] = inp // parts_b
        by["caches"] = 0
        by["argument"] = p_bytes + by["opt_state"] + by["inputs"] + 8
    elif shape.kind == "prefill":
        flops = model_flops(cfg, shape) / parts_b * dense
        mem = read
        inp = sum(t.numel() * t.element_size()
                  for t in pp.tree_leaves(inputs))
        by["inputs"] = inp // parts_b
        by["caches"] = 0
        by["argument"] = p_bytes + by["inputs"]
    else:
        caches = inputs["caches"]
        c_specs = spec_leaves(loop.cache_specs(cfg, mesh, B))
        c_leaves = pp.tree_leaves(caches)
        c_bytes = sum(_numel(shard_shape(t.shape, s, ms)) *
                      t.element_size() for t, s in zip(c_leaves, c_specs))
        flops = model_flops(cfg, shape) / parts_b * dense
        mem = read + c_bytes
        by["inputs"] = B * 4 // parts_b
        by["caches"] = c_bytes
        by["argument"] = p_bytes + by["inputs"] + c_bytes + 4
    total = float(sum(coll.values()))
    coll = {k: float(v) for k, v in coll.items()}
    t_compute = flops / PEAK_FLOPS
    t_memory = mem / HBM_BW
    t_collective = total / LINK_BW
    out.update({
        "flops_per_device": flops,
        "memory_bytes_per_device": float(mem),
        "collective_bytes_per_device": total,
        "collectives": coll,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "bottleneck": max([("compute", t_compute), ("memory", t_memory),
                           ("collective", t_collective)],
                          key=lambda kv: kv[1])[0],
        "model_flops_total": model_flops(cfg, shape),
        "bytes_per_device": by,
    })
    return out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             unroll: bool = False) -> Dict[str, Any]:
    t0 = time.time()
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    res = account(cfg, shape, mesh, run_config(cfg, shape))
    if unroll:
        res["cost_pass"] = (f"analytic(u={_partial_unroll(cfg)},"
                            f"n={_n_units(cfg)})")
    res.update(arch=arch, shape=shape_name,
               mesh="2x16x16" if multi_pod else "16x16",
               account_s=round(time.time() - t0, 3), status="ok")
    return res


SKIP_REASON = "quadratic attention @500k (docs/ARCHITECTURE.md#design-5)"


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", choices=("no", "yes", "both"),
                    default="no")
    ap.add_argument("--json", default=None)
    ap.add_argument("--unroll", action="store_true",
                    help="label each cell with the reference's partial "
                         "unroll (the port's account is exact per unit)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    pods = {"no": [False], "yes": [True],
            "both": [False, True]}[args.multi_pod]

    results = []

    def emit(r):
        results.append(r)
        if args.json:
            with open(args.json + "l", "a") as f:   # incremental JSONL
                f.write(json.dumps(r) + "\n")

    for arch in archs:
        cfg = get_config(arch)
        for sname in shapes:
            if not shape_applicable(cfg, SHAPES[sname]):
                emit({"arch": arch, "shape": sname, "status": "skip",
                      "reason": SKIP_REASON})
                print(f"SKIP  {arch:22s} {sname}")
                continue
            for mp in pods:
                try:
                    r = run_cell(arch, sname, multi_pod=mp,
                                 unroll=args.unroll)
                    emit(r)
                    gb = (r["bytes_per_device"]["argument"] +
                          r["bytes_per_device"].get("grads", 0) +
                          r["bytes_per_device"].get("accumulators", 0))
                    print(f"OK    {arch:22s} {sname:12s} {r['mesh']:8s} "
                          f"compute={r['t_compute_s']:.3e}s "
                          f"mem={r['t_memory_s']:.3e}s "
                          f"coll={r['t_collective_s']:.3e}s "
                          f"-> {r['bottleneck']:10s} "
                          f"state={gb / 2**30:.1f}GiB")
                except Exception as e:
                    emit({"arch": arch, "shape": sname,
                          "mesh": "2x16x16" if mp else "16x16",
                          "status": "fail", "error": str(e)[:2000]})
                    print(f"FAIL  {arch:22s} {sname:12s} "
                          f"{'2x16x16' if mp else '16x16'}: "
                          f"{type(e).__name__}: {str(e)[:200]}")
                    traceback.print_exc(limit=3)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    ok = sum(1 for r in results if r["status"] == "ok")
    fail = sum(1 for r in results if r["status"] == "fail")
    skip = sum(1 for r in results if r["status"] == "skip")
    print(f"\n{ok} ok / {fail} fail / {skip} skip")
    if fail:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
