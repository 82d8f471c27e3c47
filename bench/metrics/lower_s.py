"""Seconds of ``lower`` and the graphed executor's build (operands built
and uploaded), synchronised: the planning and lowering layer's share of
set-up."""


def read(ctx):
    return ctx["spans"].get("lower_s")
