"""Seconds of the executor's host operands and the exchange's index: the
program's spans ``executor.operands`` under its latest ``executor.build``,
summed."""
from benchlib.system import import_program


def read(ctx):
    import_program()
    try:
        from repro_torch import tracing
    except ImportError:                   # a program without spans
        return None
    return tracing.child_seconds("executor.build", "executor.operands")
