"""alazsan — the *runtime* half of the two-headed sanitizer (the static
half lives in ``tools/alazlint``; both share the ALZ rule vocabulary).

Two heads:

- :mod:`alaz_tpu.sanitize.lockorder` — instrumented ``Lock`` / ``RLock``
  / ``Condition`` wrappers that record per-thread acquisition stacks
  into a global lock-order graph and report cycles (the dynamic twin of
  static ALZ014). Enable with ``lockorder.instrument()`` around the code
  that *constructs* the locks.

- :mod:`alaz_tpu.sanitize.retrace` — a compile-log watcher that counts
  XLA compiles per jit entry point (``CompileWatcher``), an asserted
  per-entry-point **retrace budget** (``retrace_budget`` — the dynamic
  twin of static ALZ006), and a transfer guard for steady-state scoring
  (``no_implicit_transfers``).

Both are production-code-free: nothing in ``alaz_tpu`` imports them
outside of tests/bench instrumentation, so the hot paths carry zero
sanitizer overhead when the sanitizer is off.
"""

from alaz_tpu_torch.sanitize.lockorder import (  # noqa: F401
    LockOrderMonitor,
    LockOrderViolation,
    instrument,
)
from alaz_tpu_torch.sanitize.retrace import (  # noqa: F401
    CompileWatcher,
    RetraceBudgetExceeded,
    no_implicit_transfers,
    retrace_budget,
)
