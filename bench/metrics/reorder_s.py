"""Seconds of the lowering's reordering: the program's span
``lower.reorder`` under its latest ``lower``."""
from benchlib.system import import_program


def read(ctx):
    import_program()
    try:
        from repro_torch import tracing
    except ImportError:                   # a program without spans
        return None
    return tracing.child_seconds("lower", "lower.reorder")
