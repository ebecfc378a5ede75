"""Host launch calls per frame in the traced window of the stream (as
`forward.host_launches_per_image`)."""

from benchmark.trace import launches_per_image as read  # noqa: F401
