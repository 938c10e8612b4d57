"""The backlog in front of the aggregator: the L7 queue's pending events,
sampled every ``sample_s`` through the window, their mean."""


def read(run):
    samples = run.get("l7_pending")
    if not samples:
        return None
    return sum(samples) / len(samples)
