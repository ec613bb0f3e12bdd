"""plan_s: host seconds of the benchmark's calls into the program's plan
build (degree order, reorder, ``Aggregator.schedule_hybrid``)."""


def read(ctx):
    return ctx["plan_s"]
