"""mfu: the configuration's useful FLOPs of one pass (models/<model>.py) over
the measured window's time per pass times the float32 peak, in %."""

from portbench.flops import PEAK_FLOPS_F32


def read(ctx):
    return 100.0 * ctx["useful_flops"] / (ctx["step_s"] * PEAK_FLOPS_F32)
