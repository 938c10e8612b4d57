"""The 95th percentile, over every window scored in the window, of the
exact time from the window's close hand-off to its scores
(``Service.score_observer``), in ms. In the closed loop the queue is kept
full, so this tail follows the windows' rate: a reading of the window
queue, not an end-to-end metric."""


def read(run):
    return run.get("close_to_score_p95_ms")
