"""Seconds of the partition, the layouts and the per-shard stages: the
program's spans ``lower.stages`` under its latest ``lower``, summed."""
from benchlib.system import import_program


def read(ctx):
    import_program()
    try:
        from repro_torch import tracing
    except ImportError:                   # a program without spans
        return None
    return tracing.child_seconds("lower", "lower.stages")
