"""The split family's share of its own roofline: the compulsory bytes of
its shards a call (``benchlib.split_bound``, from the program's counters
``split.nnz``, ``split.rows``, ``split.x_elems``, ``split.y_elems``)
over the card's HBM bandwidth, against the summed device time a call of
its kernels (``seg_psum_kernel``, ``seg_fixup_kernel<..., false>``,
``split_combine_kernel``) among the traced window's device operations
(the ten names that took most of it), in %.  Nothing without a device
trace, without those kernels in it, or where the program counts no split
shard."""
from benchlib import bound, split_bound
from benchlib.system import import_program


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr.get("device_ops"):
        return None
    kernel_s = sum(s for name, s in tr["device_ops"]
                   if split_bound.is_split_kernel(name))
    import_program()
    try:
        from repro_torch import tracing
    except ImportError:                   # a program without spans
        return None
    calls = tracing.counter("spmv.calls")
    sizes = [tracing.counter("split." + k)
             for k in ("nnz", "rows", "x_elems", "y_elems")]
    if not kernel_s or not calls or not sizes[0]:
        return None
    per_call = kernel_s / ctx["counters"]["traced_calls"]
    byts = split_bound.split_bytes(*(v / calls for v in sizes))
    return 100.0 * byts / bound.PEAKS["hbm_bytes_per_s"] / per_call
