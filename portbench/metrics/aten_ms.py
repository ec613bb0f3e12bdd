"""aten_ms: device ms per pass of ATen's kernels (the residual gather,
elementwise work, the loss, the optimizer; memcpy and memset) in the trace."""


def read(ctx):
    if "summary" not in ctx:
        return None
    s = ctx["summary"]
    return 1e3 * s.class_s["aten"] / s.steps
