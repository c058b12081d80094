"""dispatch_ms_per_round (ms/round): the main thread's dispatch of a
round less its upload: DecodeStats.device_dispatch_s summed over lanes
(the batch's upload, kernel submission and reference store, split evenly
over a round's lanes) less BatchDecoder.upload_s (the upload layer's own
metric), over the window's rounds."""


def read(w):
    if not w.rounds:
        return None
    return 1e3 * (w.device_dispatch_s - w.upload_s) / w.rounds
