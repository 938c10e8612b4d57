"""TGN's memory update against its bound: its minimal bytes a window
(``yardstick_tgn.memory_update_bytes`` over the node bucket's rows) over
the HBM rate, against its mean device time (``memory.device_ms.stream``),
in %. Nothing without that device time."""

from gpu_bench import yardstick, yardstick_tgn


def read(run):
    ms = run.get("memory_device_ms")
    if not ms:
        return None
    return yardstick.roofline_pct(yardstick_tgn.memory_update_bytes(run["cfg"], run["n_pad"]), 0.0, 1e-3 * ms)
