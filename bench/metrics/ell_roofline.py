"""The ELL family's share of its own roofline: the compulsory bytes of
its shards a call (``benchlib.tile_bound.ell_bytes``, from the program's
counters ``ell.nnz``, ``ell.rows``, ``ell.x_elems``, ``ell.y_elems``)
over the card's HBM bandwidth, against the summed device time a call of
its kernel (``ell_spmv_kernel``) among the traced window's device
operations (the ten names that took most of it), in %.  Nothing without
a device trace, without that kernel in it, or where the program counts
no ELL shard."""
from benchlib import bound, tile_bound
from benchlib.system import import_program


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr.get("device_ops"):
        return None
    kernel_s = sum(s for name, s in tr["device_ops"]
                   if tile_bound.is_ell_kernel(name))
    import_program()
    try:
        from repro_torch import tracing
    except ImportError:                   # a program without spans
        return None
    calls = tracing.counter("spmv.calls")
    sizes = [tracing.counter("ell." + k)
             for k in ("nnz", "rows", "x_elems", "y_elems")]
    if not kernel_s or not calls or not sizes[0]:
        return None
    per_call = kernel_s / ctx["counters"]["traced_calls"]
    byts = tile_bound.ell_bytes(*(v / calls for v in sizes))
    return 100.0 * byts / bound.PEAKS["hbm_bytes_per_s"] / per_call
