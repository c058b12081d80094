"""decode_fps (frames/s): every frame decoded and equal to its golden,
summed over all lanes, over the wall time of the whole window."""


def read(w):
    return w.frames_ok / w.seconds
