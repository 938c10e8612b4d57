"""Mean of the program's ``handoff`` span a hand-off, in ms: the closing
thread's window enqueue (``Service._enqueue_window``), its src-locality
gauges included, as its ``alaz.handoff`` profiler ranges in the traced
window give it. In the closed loop the load's own thread hands off."""

from gpu_bench.ranges import mean_ms


def read(run):
    return mean_ms(run, "handoff")
