"""device_idle_pct.train: benchmark/core/trace.idle_pct in every traced
cell that reports train_round_ms."""

from benchmark.core.trace import idle_pct as read  # noqa: F401
