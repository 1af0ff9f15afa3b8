"""device_idle_pct.score: benchmark/core/trace.idle_pct in every traced
cell that reports score_rows_per_s."""

from benchmark.core.trace import idle_pct as read  # noqa: F401
