"""roi_align: the kernel family's share of its roofline over the traced window
(least time of its calls from `roofline.py` over its device time)."""

from benchmark.roofline import family_share


def read(measured):
    return family_share(measured, "roi_align")
