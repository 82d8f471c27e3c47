"""KB (1000 bytes) of the remote pass's buffer that the exchange builds
a call: ``[x_local ++ the halo]`` a shard, or the gathered vector."""


def read(ctx):
    b = ctx["counters"].get("exchange_bytes")
    return None if b is None else b / 1e3
