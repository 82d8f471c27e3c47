"""The tile family's share of its own roofline: the compulsory bytes of
its shards a call (``benchlib.tile_bound.tile_bytes``, from the program's
counters ``tile.nnz``, ``tile.tiles``, ``tile.x_elems``, ``tile.y_elems``)
over the card's HBM bandwidth, against the summed device time a call of
its kernels (``tile_contrib_kernel``, ``tile_contrib_general_kernel``)
among the traced window's device operations (the ten names that took
most of it), in %.  Nothing without a device trace, without those
kernels in it, or where the program counts no tile shard."""
from benchlib import bound, tile_bound
from benchlib.system import import_program


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr.get("device_ops"):
        return None
    kernel_s = sum(s for name, s in tr["device_ops"]
                   if tile_bound.is_tile_kernel(name))
    import_program()
    try:
        from repro_torch import tracing
    except ImportError:                   # a program without spans
        return None
    calls = tracing.counter("spmv.calls")
    sizes = [tracing.counter("tile." + k)
             for k in ("nnz", "tiles", "x_elems", "y_elems")]
    if not kernel_s or not calls or not sizes[0]:
        return None
    per_call = kernel_s / ctx["counters"]["traced_calls"]
    byts = tile_bound.tile_bytes(*(v / calls for v in sizes))
    return 100.0 * byts / bound.PEAKS["hbm_bytes_per_s"] / per_call
