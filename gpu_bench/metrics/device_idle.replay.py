"""The share of the traced window with no kernel, copy or set on the card."""

from gpu_bench.trace import idle_pct as read  # noqa: F401
