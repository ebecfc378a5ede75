"""The device's idle share of the stream's traced window, in % (as
`device_idle.infer`)."""

from benchmark.trace import idle_percent as read  # noqa: F401
