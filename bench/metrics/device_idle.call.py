"""The share of the traced window in which no device operation ran: 1 -
the union of the device operations' intervals over the window, in %."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr.get("busy_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
