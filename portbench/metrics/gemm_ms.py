"""gemm_ms: device ms per pass of GEMM kernels (cuBLAS, cuDNN, CUTLASS: the
dense transforms and their backward) in the trace."""


def read(ctx):
    if "summary" not in ctx:
        return None
    s = ctx["summary"]
    return 1e3 * s.class_s["gemm"] / s.steps
