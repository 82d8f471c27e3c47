"""The port's sharding specs as plain values, against the reference's:
``param_specs`` (fsdp on and off), ``state_specs``, ``batch_specs`` and
``cache_specs`` on all ten configs, smoke and published, over the meshes
(1, 1), (2, 2), (1, 2), (2, 1), 16x16 and 2x16x16 (the reference's side on
``jax.sharding.AbstractMesh``, the port's on an abstract ``Mesh``);
``make_production_mesh``'s names and sizes, and the constraint rule
(``sharding.resolve_spec`` against the reference's ``_maybe_constrain``,
whose specs a subprocess of 512 fake devices records).  Specs compare as
tuples, as ``PartitionSpec`` does.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import jax
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import registry as rreg
from repro.models import params as rparams
from repro.optim import adamw as radamw
from repro.train import loop as rloop
from repro_torch.configs import registry as treg
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import params as tparams
from repro_torch.models.sharding import P, resolve_spec, shard_shape
from repro_torch.optim import adamw as tadamw
from repro_torch.train import loop as tloop

ROOT = Path(__file__).resolve().parents[1]
MESHES = [(("data", "model"), (1, 1)), (("data", "model"), (2, 2)),
          (("data", "model"), (1, 2)), (("data", "model"), (2, 1)),
          (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]
MESH_IDS = ["x".join(map(str, s)) for _, s in MESHES]
CONFIGS = [(a, smoke) for a in treg.ARCH_IDS for smoke in (True, False)]
CONFIG_IDS = [f"{a}-{'smoke' if s else 'full'}" for a, s in CONFIGS]
BATCHES = (1, 2, 4, 8, 128, 256)


def configs(arch, smoke):
    if smoke:
        return rreg.get_smoke_config(arch), treg.get_smoke_config(arch)
    return rreg.get_config(arch), treg.get_config(arch)


def meshes(names, sizes):
    return AbstractMesh(sizes, names), Mesh(names, sizes, ())


def ref_leaves(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))]


def port_leaves(tree):
    """The specs of a tree in the order ``jax.tree.leaves`` visits it
    (dict keys sorted, NamedTuple fields in order)."""
    if isinstance(tree, P):
        return [tuple(tree)]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in port_leaves(tree[k])]
    return [s for v in tree for s in port_leaves(v)]


@pytest.mark.parametrize("arch,smoke", CONFIGS, ids=CONFIG_IDS)
def test_param_and_state_specs(arch, smoke):
    rcfg, tcfg = configs(arch, smoke)
    for fsdp in (True, False):
        want = rparams.param_specs(rcfg, fsdp=fsdp)
        got = tparams.param_specs(tcfg, fsdp=fsdp)
        assert port_leaves(got) == ref_leaves(want)
        assert isinstance(got["embed"], P)
        assert port_leaves(tadamw.state_specs(got)) == \
            ref_leaves(radamw.state_specs(want))
        # the key paths too, not only the order
        names = [str(p) for p, _ in jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]]
        assert len(names) == len(port_leaves(got))


@pytest.mark.parametrize("names,sizes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch,smoke", CONFIGS, ids=CONFIG_IDS)
def test_mesh_specs(arch, smoke, names, sizes):
    """``param_shardings``' specs, ``batch_specs`` and ``cache_specs`` on
    one mesh, with the shard shapes of every parameter."""
    rcfg, tcfg = configs(arch, smoke)
    rmesh, tmesh = meshes(names, sizes)
    for fsdp in (True, False):
        run = tloop.RunConfig(fsdp=fsdp)
        want = rparams.param_specs(rcfg, fsdp=fsdp)
        got = tloop.param_specs_for(tcfg, tmesh, run)
        assert port_leaves(got) == ref_leaves(want)
        shapes = [a.shape for a in jax.tree.leaves(
            rparams.abstract_params(rcfg))]
        assert [shard_shape(s, sp, tmesh.shape) for s, sp in zip(
            shapes, port_leaves(got))] == [
            tuple(-(-n // _parts(e, rmesh)) for n, e in zip(
                s, tuple(sp) + (None,) * (len(s) - len(sp))))
            for s, sp in zip(shapes, ref_leaves(want))]
    for b in BATCHES:
        assert tuple(tloop.batch_specs(tcfg, tmesh, b)("tokens")) == \
            tuple(rloop.batch_specs(rcfg, rmesh, b)("tokens"))
        assert port_leaves(tloop.cache_specs(tcfg, tmesh, b)) == \
            ref_leaves(rloop.cache_specs(rcfg, rmesh, b))


def _parts(entry, rmesh) -> int:
    axes = () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))
    n = 1
    for a in axes:
        n *= rmesh.shape[a]
    return n


def test_batch_axes_and_cache_tree_structure():
    for names, sizes in MESHES:
        rmesh, tmesh = meshes(names, sizes)
        assert tloop.batch_axes_of(tmesh) == rloop.batch_axes_of(rmesh)
    cfg = treg.get_config("recurrentgemma_2b")
    specs = tloop.cache_specs(cfg, Mesh(("data", "model"), (2, 2), ()), 4)
    assert sorted(specs) == ["prefix", "stack", "tail"]


#: (shape, axes) cases of the constraint rule, for every mesh.
RESOLVE_CASES = [
    ((8, 4, 6), (("pod", "data"), None, "model")),
    ((3, 4), ("data", "model")),
    ((1, 16), ("data", "model")),
    ((16, 8, 32), ("model", None, None)),
    ((8, 16, 4), (None, "data", None)),
    ((4, 1, 4, 2, 32), (("pod", "data"), None, None, None, "model")),
    ((64, 512, 64), ("model", None, None)),
    ((6, 10), (None, ("data", "model"))),
    ((32, 7, 48), (("pod", "data"), None, "model")),
    ((2, 16), ("pod", "model")),
    ((5,), (None,)),
]

_PROBE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, jax, jax.numpy as jnp
from repro.launch.mesh import auto_axis_types, make_production_mesh
from repro.models import model as rm
seen = []
jax.lax.with_sharding_constraint = lambda x, s: (seen.append(s.spec), x)[1]
meshes, cases = json.loads(os.environ["PROBE_ARGS"])
out = {"production": [[list(m.axis_names), [m.shape[a] for a in
                                           m.axis_names]]
                      for m in (make_production_mesh(multi_pod=False),
                                make_production_mesh(multi_pod=True))],
       "resolved": []}
for names, sizes in meshes:
    m = jax.make_mesh(tuple(sizes), tuple(names),
                      **auto_axis_types(len(names)))
    got = []
    with m:
        for shape, axes in cases:
            seen.clear()
            rm._maybe_constrain(jnp.zeros(shape),
                                *[tuple(a) if isinstance(a, list) else a
                                  for a in axes])
            got.append([list(e) if isinstance(e, tuple) else e
                        for e in seen[0]])
    out["resolved"].append(got)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def probe():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               PROBE_ARGS=json.dumps([MESHES, RESOLVE_CASES]))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_production_mesh(probe):
    for multi_pod, (names, sizes) in zip((False, True), probe["production"]):
        m = make_production_mesh(multi_pod=multi_pod)
        assert list(m.axis_names) == names
        assert list(m.axis_sizes) == sizes
        assert m.shape == dict(zip(names, sizes))
        assert m.abstract and not m.distributed and m.devices == ()
        assert m.size == (512 if multi_pod else 256)


@pytest.mark.parametrize("i", range(len(MESHES)), ids=MESH_IDS)
def test_constraint_rule(probe, i):
    names, sizes = MESHES[i]
    shape = dict(zip(names, sizes))
    got = [[list(e) if isinstance(e, tuple) else e
            for e in resolve_spec(s, a, shape)] for s, a in RESOLVE_CASES]
    assert got == probe["resolved"][i]


def test_expert_and_tensor_parallel_choices():
    """Under a placement on a (2, 2) mesh: experts go over "model" where E
    divides it (deepseek's 8, grok's 4 and its split 8), capacity over
    "data" otherwise; and the layers whose products split over "model"
    (no devices are needed to decide)."""
    from repro_torch.models import model as tm
    from repro_torch.models import moe as tmoe
    from repro_torch.models import sharding as sh
    mesh = Mesh(("data", "model"), (2, 2), ())
    with sh.use(sh.Placement(mesh, ("data",), True, tp_axis="model")):
        for e in (8, 4, 16):
            assert tmoe._expert_axes(e) == ("model", None, None)
        assert tmoe._expert_axes(3) == (None, "data", None)
    assert tmoe._ep_possible(8) is False            # outside a placement
    qwen = treg.get_smoke_config("qwen3_4b")
    block = tparams.abstract_params(qwen)["stack"]["u0_attn"]
    assert set(tm.tp_split(qwen, "attn", block, 2)) == {
        "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
    # recurrentgemma's single KV head does not split over two ranks
    rg = treg.get_smoke_config("recurrentgemma_2b")
    tail = tparams.abstract_params(rg)["stack"]["u2_local_attn"]
    assert set(tm.tp_split(rg, "local_attn", tail, 2)) == {
        "w_gate", "w_up", "w_down"}
    ds = treg.get_smoke_config("deepseek_moe_16b")
    moe_block = tparams.abstract_params(ds)["stack"]["u0_moe"]
    assert set(tm.tp_split(ds, "moe", moe_block, 2)) == {
        "wq", "wk", "wv", "wo", "s_gate", "s_up", "s_down"}
