"""The share of the traced window's calls that found all earlier work of
the executor done at entry, so the device waited for the host: 100 x the
program's counters ``spmv.starved`` / ``spmv.calls``, in %."""
from benchlib.system import import_program


def read(ctx):
    import_program()
    try:
        from repro_torch import tracing
    except ImportError:                   # a program without spans
        return None
    calls = tracing.counter("spmv.calls")
    return 100.0 * tracing.counter("spmv.starved") / calls if calls else None
