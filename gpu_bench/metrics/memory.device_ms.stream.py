"""Mean device time of TGN's memory update a window scored in the window,
in ms: the program's ``latency.memory_device_s`` (a CUDA event pair around
the update's launches, read once the window's logits were read), its sum
and count taken at the window's open and close. Nothing where the program
has no such series."""


def read(run):
    return run.get("memory_device_ms")
