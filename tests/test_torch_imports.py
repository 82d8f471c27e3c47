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


@pytest.mark.parametrize("path", REF_MODULES,
                         ids=lambda p: str(p.relative_to(ROOT / "src")))
def test_reference_names_resolve_on_the_port(path):
    """Every public name of a reference module is found on the port's
    namesake module, but the XLA-only names of ``NOT_PORTED``."""
    import importlib
    rel = path.relative_to(ROOT / "src")
    parts = ("repro_torch",) + rel.with_suffix("").parts[1:]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    mod = importlib.import_module(".".join(parts))
    skip = NOT_PORTED.get(str(rel), set())
    names = _public_names(path)
    assert skip <= set(names), skip - set(names)
    missing = [n for n in names if n not in skip and not hasattr(mod, n)]
    assert not missing, f"{mod.__name__} lacks {missing}"
