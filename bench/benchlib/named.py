"""Modules found by name: ``bench/<folder>/<name>.py``.

A matrix generator (``generators``), a kind of traffic (``kinds``) and a
per-layer metric's reader (``metrics``) each live in a file of their
own, named as ``BENCHMARK.json`` or a data file names them, so a new one
is a new file and no existing file changes.
"""
from __future__ import annotations

import functools
import importlib.util
import re
from pathlib import Path

__all__ = ["BENCH", "module"]

#: The benchmark's folder (a test may point it at a copy).
BENCH = Path(__file__).resolve().parents[1]
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def module(folder: str, name: str):
    """The module ``<BENCH>/<folder>/<name>.py``."""
    path = BENCH / folder / f"{name}.py"
    if not _NAME.match(name) or not path.is_file():
        raise KeyError(f"no {folder} module {name!r} (looked for {path})")
    return _load(path, f"bench_{folder}_" + re.sub(r"[.\-]", "_", name))


@functools.cache
def _load(path: Path, modname: str):
    """The module at ``path``, loaded once."""
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
