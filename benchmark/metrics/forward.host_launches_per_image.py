"""Host launch calls (`cudaLaunchKernel` and its kin, a `cudaGraphLaunch`
once) in the traced window's CPU events, per image the window completed:
what host dispatch of the forward pays."""

from benchmark.trace import launches_per_image as read  # noqa: F401
