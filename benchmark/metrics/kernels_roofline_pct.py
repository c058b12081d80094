"""kernels_roofline_pct (%): the least bytes the window's pictures need
(roofline.picture_bytes) over the card's peak bandwidth, over the
kernels' summed time in the device trace.  Bounded by bytes."""

from benchmark import roofline


def read(w):
    if w.trace is None:
        return None
    return roofline.roofline_pct(w.picture_bytes, w.trace["kernel_s"])
