"""device_idle_pct (%): the share of the traced window in which no
kernel, copy or set ran on the card (torch.profiler's device events)."""


def read(w):
    if w.trace is None:
        return None
    return 100.0 * (1.0 - w.trace["busy_s"] / w.trace["window_s"])
