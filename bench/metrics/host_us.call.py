"""Microseconds of the host a call of the executor takes, lock and graph
entry included: the mean duration of the program's span ``spmv.call``
in the traced window's recording session."""
from benchlib.system import import_program


def read(ctx):
    import_program()
    try:
        from repro_torch import tracing
    except ImportError:                   # a program without spans
        return None
    t = tracing.total("spmv.call")
    return t[1] / t[0] * 1e6 if t and t[0] else None
