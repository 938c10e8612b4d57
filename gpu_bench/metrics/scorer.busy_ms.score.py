"""The scorer thread's busy time a scored window (``Service._scorer_busy_s``
over the window's scored windows): staging, dispatch and the wait for the
logits, in ms."""


def read(run):
    if not run.get("windows_scored"):
        return None
    return 1e3 * run["scorer_busy_s"] / run["windows_scored"]
