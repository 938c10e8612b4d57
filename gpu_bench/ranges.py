"""The program's spans as a traced run sees them: the profiler ranges
``alaz.<stage>`` that ``alaz_tpu_torch/obs/spans.py`` opens while a
``torch.profiler`` session records, among the trace's host operations.

The benchmark's session (``trace.traced``) records the operations of the
thread that starts it, the load's own: the closing thread's hand-off in
the windows cell and the train step in the train cell. A program
without the span, or a span on another thread, leaves nothing to read.
"""

from __future__ import annotations


def mean_ms(run: dict, stage: str):
    """Mean length of the ``alaz.<stage>`` ranges that overlap the traced
    window (each whole), in ms; None without a trace or a range."""
    tr = run.get("trace")
    if tr is None:
        return None
    durs = [e - s for name, s, e, _ in tr.host if name == "alaz." + stage]
    return 1e-6 * sum(durs) / len(durs) if durs else None
