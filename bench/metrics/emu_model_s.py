"""Seconds of the Emu model's accounting that the lowering runs
(``count_migrations``, ``remote_access_matrix``): the program's span
``lower.emu_accounting`` under its latest ``lower``."""
from benchlib.system import import_program


def read(ctx):
    import_program()
    try:
        from repro_torch import tracing
    except ImportError:                   # a program without spans
        return None
    return tracing.child_seconds("lower", "lower.emu_accounting")
