"""Mean of the span stage ``stage`` (host arrays, page-locked fill and the
copy's dispatch) over the windows whose spans completed in the window, ms."""


def read(run):
    if not run.get("stage_count"):
        return None
    return 1e3 * run["stage_s_sum"] / run["stage_count"]
