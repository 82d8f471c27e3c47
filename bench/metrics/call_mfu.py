"""The whole call's share of the card's peak: the compulsory bound of a
call over the traced window's wall time a call, in %.  For SpMV the
bytes term of the bound binds, so this is a share of HBM bandwidth."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr.get("device_op_s"):
        return None
    per_call = tr["window_s"] / ctx["counters"]["traced_calls"]
    return 100.0 * ctx["bound"]["s"] / per_call
