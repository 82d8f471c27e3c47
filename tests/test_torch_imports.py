"""Import hygiene of the port: no JAX, nothing of ``repro``, and no quiet
fallback to the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import program as t_program
from repro_torch.core.sparse_matrix import csr_from_coo
from repro_torch.core.spmv import SpmvPlan

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples_torch").glob("*.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    EXAMPLES + [ROOT / "chip_smoke.py"]
REF_MODULES = sorted((ROOT / "src" / "repro").rglob("*.py"))
#: Names of the reference with no namesake in the port: XLA's and the
#: TPU's (ROADMAP, "Not ported, and why").  The port's dry run counts
#: its own collectives from the specs (``account``, ``LINK_BW``) where
#: the reference lowers and compiles each cell and reads XLA's analyses.
NOT_PORTED = {
    "repro/launch/dryrun.py": {"collective_bytes_from_hlo", "lower_cell",
                               "analyze", "ICI_BW"},
    "repro/launch/mesh.py": {"auto_axis_types"},
}
#: Parameters of the reference with no namesake in the port, by module
#: and qualified function name.  ``"*"`` stands for a whole signature
#: that is its TPU kernel's own; ``"**tiles"`` for a ``**`` parameter.
_KERNEL_KW = {"use_kernel", "interpret"}
NOT_PORTED_PARAMS = {
    # The executors' Pallas switches: the port has one path per device.
    "repro/core/program.py": {
        "make_program_spmv_fn": _KERNEL_KW, "execute": _KERNEL_KW},
    # The legacy shims' Pallas switches, as the executors'.
    "repro/core/spmv.py": {
        "make_spmv_fn": _KERNEL_KW, "make_seg_spmv_fn": _KERNEL_KW,
        "make_halo_spmv_fn": _KERNEL_KW},
    # The per-format API's Pallas switches and TPU tile sizes
    # (repro_torch.kernels.ops's docstring): the CUDA kernels fix their own.
    "repro/kernels/ops.py": {
        "ell_spmv": {"interpret", "**tiles"},
        "hyb_spmv": _KERNEL_KW, "bell_spmv": _KERNEL_KW,
        "bell_spmm": _KERNEL_KW | {"tile_b"},
        "seg_spmv": _KERNEL_KW | {"tile_c"},
        "split_spmv": _KERNEL_KW | {"tile_c"},
        "split_flat_spmv": _KERNEL_KW | {"tile_c"},
        "tile_spmv": _KERNEL_KW, "tile_flat_spmv": _KERNEL_KW},
    # The raw Pallas wrappers' contracts are the TPU kernels' own; the
    # port's kernels of these names take the executor's S-stacked operands.
    "repro/kernels/spmv_ell.py": {"ell_spmv": {"*"}},
    "repro/kernels/spmv_seg.py": {"seg_psum": {"*"}},
    "repro/kernels/spmv_split.py": {"split_psum": {"*"},
                                    "split_combine": {"*"}},
    "repro/kernels/spmv_tile.py": {"tile_walk_spmv": {"*"},
                                   "tile_contrib": {"*"}},
    # A JAX key has no torch counterpart: ``rng`` became ``generator``;
    # ``block_apply`` takes the Valiant shuffle's ``perm``, drawn once by
    # its caller, so that a rematerialised block does not draw again.
    "repro/models/model.py": {"block_apply": {"rng"}, "forward": {"rng"},
                              "loss_fn": {"rng"}},
    # ``rng`` became ``generator``, as in the model.
    "repro/models/moe.py": {"moe_ffn": {"rng"}},
    # ``key`` became ``generator`` (same position).
    "repro/models/params.py": {"init_params": {"key"}},
    # ``key`` became ``generator`` (same position).
    "repro/serve/engine.py": {"Engine.generate": {"key"}},
    # A mesh axis name became a torch.distributed process group.
    "repro/optim/grad_compress.py": {"psum_compressed": {"axis"}},
}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, importlib.util\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"for i, p in enumerate({[str(p) for p in EXAMPLES]!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'ex{i}', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not any(k.split('.')[0] in ('jax', 'repro')\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_raise_without_cuda(monkeypatch):
    """Called without ``device=``, the executor wants CUDA and raises
    where it is absent; it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    A = csr_from_coo(rng.integers(0, 64, 300), rng.integers(0, 64, 300),
                     rng.standard_normal(300), (64, 64))
    prog = t_program.lower(A, SpmvPlan(num_shards=2, kernel="seg"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_program.make_program_spmv_fn(prog)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_program.execute(prog, np.ones(64), backend="device")
    y = t_program.execute(prog, np.ones(64), backend="device", device="cpu")
    assert y.shape == (64,)


def test_mesh_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The sharded slice's entry points want CUDA unless ``device="cpu"``
    is passed: the host mesh, the process group's bring-up and the
    launcher raise without it; on a CPU host mesh ``train_loop`` runs."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.synthetic import DataConfig, TokenStream
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import train_loop
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (make_host_mesh, init_distributed,
                 lambda: launch_train.main(["--smoke", "--steps", "1",
                                            "--ckpt", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    cfg = get_smoke_config("qwen3_4b")
    mesh = make_host_mesh(device="cpu")
    assert not mesh.distributed and mesh.local_device.type == "cpu"
    _, opt, metrics = train_loop(
        cfg, AdamWConfig(), mesh,
        TokenStream(cfg, DataConfig(batch=2, seq_len=8)), 1)
    assert int(opt.step) == 1 and np.isfinite(metrics["loss"])


def _public_names(path: Path) -> list:
    """A reference module's ``__all__`` where it has one; otherwise its
    public top-level functions, classes and UPPER_CASE constants.  Read
    with ``ast``: importing some reference modules sets XLA flags."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if "__all__" in targets:
                return list(ast.literal_eval(node.value))
            names += [t for t in targets if t.isupper()]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
    return [n for n in names if not n.startswith("_")]


def _port_module(path: Path):
    """The port's namesake of the reference module at ``path``."""
    import importlib
    rel = path.relative_to(ROOT / "src")
    parts = ("repro_torch",) + rel.with_suffix("").parts[1:]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return importlib.import_module(".".join(parts))


@pytest.mark.parametrize("path", REF_MODULES,
                         ids=lambda p: str(p.relative_to(ROOT / "src")))
def test_reference_names_resolve_on_the_port(path):
    """Every public name of a reference module is found on the port's
    namesake module, but the XLA-only names of ``NOT_PORTED``."""
    rel = path.relative_to(ROOT / "src")
    mod = _port_module(path)
    skip = NOT_PORTED.get(str(rel), set())
    names = _public_names(path)
    assert skip <= set(names), skip - set(names)
    missing = [n for n in names if n not in skip and not hasattr(mod, n)]
    assert not missing, f"{mod.__name__} lacks {missing}"


def _public_classes(tree: ast.Module) -> list:
    """The public classes a reference module defines: those of its
    ``__all__`` where it has one, else its top-level classes."""
    exported = None
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            exported = set(ast.literal_eval(node.value))
    return [node for node in tree.body if isinstance(node, ast.ClassDef)
            and (node.name in exported if exported is not None
                 else not node.name.startswith("_"))]


def _method_kind(fn: ast.FunctionDef) -> str:
    for d in fn.decorator_list:
        if isinstance(d, ast.Name) and d.id in ("property", "staticmethod",
                                                 "classmethod"):
            return d.id
        if isinstance(d, ast.Attribute) and d.attr in ("setter", "getter",
                                                        "deleter"):
            return "property"
    return "method"


def _public_members(cls: ast.ClassDef) -> list:
    """A reference class's public methods and properties; ``__init__``
    counts as public."""
    return [node for node in cls.body if isinstance(node, ast.FunctionDef)
            and (not node.name.startswith("_") or node.name == "__init__")]


@pytest.mark.parametrize("path", REF_MODULES,
                         ids=lambda p: str(p.relative_to(ROOT / "src")))
def test_reference_class_members_resolve(path):
    """Every public method and property of each public class of a
    reference module is found on the port's namesake class."""
    mod = _port_module(path)
    tree = ast.parse(path.read_text(), filename=str(path))
    missing = []
    for cls in _public_classes(tree):
        port_cls = getattr(mod, cls.name, None)
        missing += [f"{cls.name}.{m.name}" for m in _public_members(cls)
                    if port_cls is None or not hasattr(port_cls, m.name)]
    assert not missing, f"{mod.__name__} lacks {missing}"


def _ref_functions(tree: ast.Module):
    """(qualified name, node, kind) of each public top-level function and
    of each public method of a public class (properties left out)."""
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            yield node.name, node, "function"
    for cls in _public_classes(tree):
        for m in _public_members(cls):
            kind = _method_kind(m)
            if kind != "property":
                yield f"{cls.name}.{m.name}", m, kind


def _ref_params(fn: ast.FunctionDef, kind: str):
    """(positional names, every name) of a reference signature, without
    ``self``/``cls``; ``*``/``**`` parameters as ``"*name"``/``"**name"``."""
    a = fn.args
    pos = [p.arg for p in a.posonlyargs + a.args]
    if kind in ("method", "classmethod"):
        pos = pos[1:]
    names = pos + [p.arg for p in a.kwonlyargs]
    if a.vararg is not None:
        names.append("*" + a.vararg.arg)
    if a.kwarg is not None:
        names.append("**" + a.kwarg.arg)
    return pos, names


def _port_signature(mod, qual: str):
    """The port's signature of ``qual`` without ``self``/``cls``; None
    where the port has no such function."""
    import inspect
    if "." not in qual:
        obj = getattr(mod, qual, None)
        return None if obj is None else inspect.signature(obj)
    cls_name, name = qual.split(".")
    port_cls = getattr(mod, cls_name, None)
    if port_cls is None or not hasattr(port_cls, name):
        return None
    raw = inspect.getattr_static(port_cls, name)
    assert not isinstance(raw, property), f"{qual} is a property on the port"
    fn = raw.__func__ if isinstance(raw, (staticmethod, classmethod)) else raw
    sig = inspect.signature(fn)
    params = list(sig.parameters.values())
    if not isinstance(raw, staticmethod):
        params = params[1:]
    return sig.replace(parameters=params)


def _binding_faults(pos, names, sig, skip=frozenset()) -> list:
    """How a call that binds to the reference's signature (``pos``,
    ``names``) fails to bind to the port's ``sig``: a name it lacks
    (unless it takes ``**kwargs``), or a reference positional parameter
    not positional at the same index."""
    from inspect import Parameter
    kinds = {p.kind for p in sig.parameters.values()}
    takes_kwargs = Parameter.VAR_KEYWORD in kinds
    takes_args = Parameter.VAR_POSITIONAL in kinds
    port_pos = [p.name for p in sig.parameters.values()
                if p.kind in (Parameter.POSITIONAL_ONLY,
                              Parameter.POSITIONAL_OR_KEYWORD)]
    faults = []
    for name in names:
        if name in skip:
            continue
        if name.startswith("**"):
            ok = takes_kwargs
        elif name.startswith("*"):
            ok = takes_args
        else:
            ok = name in sig.parameters or takes_kwargs
        if not ok:
            faults.append(f"lacks {name}")
    for i, name in enumerate(pos):
        if name in skip or (i < len(port_pos) and port_pos[i] == name) or \
                (i >= len(port_pos) and takes_args):
            continue
        faults.append(f"{name} is not positional at {i}")
    return faults


@pytest.mark.parametrize("path", REF_MODULES,
                         ids=lambda p: str(p.relative_to(ROOT / "src")))
def test_reference_parameters_bind(path):
    """Each parameter of every public function and method that both
    packages have is found on the port's, each positional one at the
    same index, but the exceptions of ``NOT_PORTED_PARAMS``; and each
    exception still names a parameter the reference has and the port
    lacks."""
    rel = str(path.relative_to(ROOT / "src"))
    mod = _port_module(path)
    tree = ast.parse(path.read_text(), filename=str(path))
    excepted = NOT_PORTED_PARAMS.get(rel, {})
    seen, faults = set(), []
    for qual, fn, kind in _ref_functions(tree):
        sig = _port_signature(mod, qual)
        if sig is None:
            continue
        seen.add(qual)
        pos, names = _ref_params(fn, kind)
        skip = excepted.get(qual, set())
        if "*" in skip:
            assert _binding_faults(pos, names, sig), \
                f"{rel}: {qual}'s exception is stale: its call binds"
            continue
        assert skip <= set(names), \
            f"{rel}: {qual} no longer has {skip - set(names)}"
        assert len(_binding_faults([], sorted(skip), sig)) == len(skip), \
            f"{rel}: {qual}'s exception is stale: the port has some of {skip}"
        faults += [f"{qual}: {f}" for f in
                   _binding_faults(pos, names, sig, skip)]
    assert set(excepted) <= seen, \
        f"{rel}: exceptions for functions not on both: {set(excepted) - seen}"
    assert not faults, f"{mod.__name__}: {faults}"
