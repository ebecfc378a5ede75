"""1 - the union of the device's operation intervals over the traced
window's wall time, in %."""

from benchmark.trace import idle_percent as read  # noqa: F401
