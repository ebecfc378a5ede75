"""The stream's forward's share of the bf16 peak: model FLOPs per frame
times the frames of the measured window, over its seconds (as
`mfu.infer`; the on-device paste is not counted)."""

from benchmark.roofline import mfu_percent as read  # noqa: F401
