"""frame_gap_p95_ms (ms): the 95th percentile, over all lanes and frames
of the window, of the gap between one lane's consecutive frames, timed
by the device consumer's on_frame on the host clock.  Device output
only: a host cell has no per-frame hook."""

import numpy as np


def read(w):
    if not w.gaps_s:
        return None
    return float(np.percentile(w.gaps_s, 95)) * 1e3
