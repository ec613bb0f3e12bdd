"""idle_share: the share of the traced window in which no kernel, copy or
memset runs on the device, in %."""


def read(ctx):
    if "summary" not in ctx:
        return None
    return 100.0 * ctx["summary"].idle_share
