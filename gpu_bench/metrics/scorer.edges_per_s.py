"""The closed loop's rate: the edges of the windows whose scores the
Service recorded in the window, over its seconds. The scorer's serial host
work sets it, and the host's noise swings it from run to run."""


def read(run):
    return run.get("edges_scored_per_s")
