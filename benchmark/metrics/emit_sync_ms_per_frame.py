"""emit_sync_ms_per_frame (ms/frame): DecodeStats.emit_sync_s (waiting
for and copying out each frame's device-to-host copy) summed over lanes,
over the frames.  Host output only."""


def read(w):
    if w.output != "host" or not w.frames:
        return None
    return 1e3 * w.emit_sync_s / w.frames
