"""kernel_ms_per_frame (ms/frame): the kernels' summed durations in the
traced window's device trace (torch.profiler, CUDA activity), over the
frames."""


def read(w):
    if w.trace is None or not w.frames:
        return None
    return 1e3 * w.trace["kernel_s"] / w.frames
