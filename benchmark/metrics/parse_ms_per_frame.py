"""parse_ms_per_frame (ms/frame): DecodeStats.host_parse_s (parse,
ABI pack, wire pack) summed over lanes, over the frames.  Lane-seconds,
not wall time: the pool's lanes parse at once."""


def read(w):
    return 1e3 * w.host_parse_s / w.frames if w.frames else None
