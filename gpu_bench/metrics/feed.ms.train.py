"""Mean of the program's ``feed`` span a train step, in ms: the copies of
the numpy window and its labels to the card (pageable), as its
``alaz.feed`` profiler ranges in the traced window give it."""

from gpu_bench.ranges import mean_ms


def read(run):
    return mean_ms(run, "feed")
