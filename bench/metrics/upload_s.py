"""Seconds of the executor's copies to the device, each waited for: the
program's spans ``executor.upload`` under its latest ``executor.build``,
summed."""
from benchlib.system import import_program


def read(ctx):
    import_program()
    try:
        from repro_torch import tracing
    except ImportError:                   # a program without spans
        return None
    return tracing.child_seconds("executor.build", "executor.upload")
