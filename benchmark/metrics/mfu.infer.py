"""The inference forward's share of the bf16 peak: model FLOPs per image
(`roofline.model_flops_per_image`, from the configuration's shapes) times
the images of the run's measured window, over its seconds."""

from benchmark.roofline import mfu_percent as read  # noqa: F401
