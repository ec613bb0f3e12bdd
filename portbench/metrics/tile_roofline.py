"""tile_roofline: the tile kernels' least time (flops.launch_bound_s over
every launch of the traced passes) over the device time of the port's
kernels in them, in %.  Nothing where the trace or the launch counters
cannot be trusted."""


def read(ctx):
    if not ctx.get("launches_agree") or ctx.get("bounds") is None:
        return None
    port_s = ctx["summary"].class_s["port"]
    return 100.0 * ctx["bounds"] / port_s if port_s > 0 else None
