"""The comparison that decides `correct`: every frame that the window
produced, byte for byte, against libavcodec's decode of the same bytes.

The reference is libavcodec (through tools/h264ref, where the goldens
were made; see make_streams.py): the MD5 of each of its frames, planar
Y, Cb, Cr of the display size, in output order, kept under
benchmark/data.  A frame is right when the MD5 of its planes equals its
golden's.  This reads the port's output only to judge it; it imports
nothing of the port.

Each number compared is a count with the limit 0, an exact comparison:
frames whose bytes differ, golden frames that never came, frames past a
lane's golden, and lanes that failed.
"""

from __future__ import annotations

import hashlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

LIMITS = {"frames_wrong": 0, "frames_missing": 0, "frames_extra": 0,
          "lanes_failed": 0}
BLOCK_BYTES = 1 << 28       # device frames copied to the host per block
HASH_THREADS = 8            # hashlib releases the GIL on large buffers


def md5_planes(planes) -> str:
    h = hashlib.md5()
    for p in planes:
        h.update(np.ascontiguousarray(p).data)
    return h.hexdigest()


def host_md5s(frames, control: bool = False) -> list[list[str]]:
    """Per lane, the MD5 of each host frame (`.y`, `.cb`, `.cr` numpy
    planes).  control: each sample's lowest bit cleared first."""
    def one(f):
        planes = (f.y, f.cb, f.cr)
        if control:
            planes = tuple(p & 0xFE for p in planes)
        return md5_planes(planes)

    with ThreadPoolExecutor(HASH_THREADS) as pool:
        return [list(pool.map(one, lane)) for lane in frames]


def arena_md5s(arena, counts, bases, control: bool = False
               ) -> list[list[str]]:
    """Per lane, the MD5 of each frame held in `arena` ([frames, bytes]
    uint8 tensor, one frame's planar bytes a row; lane i's j-th frame at
    row bases[i] + j for j < counts[i]), copied to the host block by
    block.  control: each sample's lowest bit cleared first."""
    import torch
    if control:
        arena.bitwise_and_(0xFE)
    rows = max(1, BLOCK_BYTES // max(1, arena.shape[1]))
    digests: list = [None] * arena.shape[0]
    with ThreadPoolExecutor(HASH_THREADS) as pool:
        for r0 in range(0, arena.shape[0], rows):
            block = arena[r0:r0 + rows].to("cpu", torch.uint8).numpy()
            for j, d in enumerate(pool.map(
                    lambda row: hashlib.md5(row.data).hexdigest(), block)):
                digests[r0 + j] = d
    return [digests[b:b + n] for b, n in zip(bases, counts)]


def compare(got: list[list[str]], want: list[list[str]],
            failed: list[bool], extra: list[int]) -> dict:
    """The numbers compared, each {"value", "limit"}: got, per lane, the
    MD5s of the frames it produced (at most its golden's count); want, the
    goldens; failed, whether the program reported the lane failed; extra,
    frames a lane produced past its golden."""
    wrong = sum(a != b for g, w in zip(got, want) for a, b in zip(g, w))
    missing = sum(max(0, len(w) - len(g)) for g, w in zip(got, want))
    values = {"frames_wrong": wrong, "frames_missing": missing,
              "frames_extra": sum(extra), "lanes_failed": sum(failed)}
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}


def correct(compared: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in compared.values())
