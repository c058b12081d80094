"""upload_ms_per_round (ms/round): BatchDecoder.upload_s (the main
thread's spec merge, wire emit and copy to the card), over rounds."""


def read(w):
    return 1e3 * w.upload_s / w.rounds if w.rounds else None
