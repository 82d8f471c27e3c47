"""KB (1000 bytes) of device scratch the split family allocates a call:
its running sums and per-split partials in both passes, the program's
counter ``split.scratch_bytes`` over ``spmv.calls`` in the traced
window's recording session.  Nothing where the program counts none (a
program without the counter, or no split shard)."""
from benchlib.system import import_program


def read(ctx):
    import_program()
    try:
        from repro_torch import tracing
    except ImportError:                   # a program without spans
        return None
    calls = tracing.counter("spmv.calls")
    scratch = tracing.counter("split.scratch_bytes")
    return scratch / calls / 1e3 if calls and scratch else None
