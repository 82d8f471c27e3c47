"""The compulsory bound of a call over the device time a call: the
summed durations of every device operation in the traced window (kernels,
copies, sets), over the calls in it, in %."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr.get("device_op_s"):
        return None
    per_call = tr["device_op_s"] / ctx["counters"]["traced_calls"]
    return 100.0 * ctx["bound"]["s"] / per_call
