"""Streams, their goldens, and the lanes that a seed makes of a stream set.

A stream set is a list of names; each name has a golden file
`benchmark/data/NAME.json` that says where the stream's bytes are
(`file`, relative to the checkout), their SHA-256, and what libavcodec
decoded from them: the MD5 of every frame in output order, the structure
(each coded picture's slice type in decode order).

A lane decodes whole streams back to back, each a coded video sequence of
its own (SPS, PPS, IDR), joined into one byte string a
`BatchDecoder.decode` call (`streams_per_call` of them): the seed picks
each lane's order of the set's streams, so lanes side by side decode
different streams and the picture kinds of a round mix differently.

Nothing here imports the decoder under test.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
SLICE_KIND = "PBI"          # slice_type % 5: P 0, B 1, I 2
VCL = (1, 5)                # coded slice NAL unit types (non-IDR, IDR)
IDR = 5


@dataclass(frozen=True)
class Stream:
    name: str
    data: bytes
    width: int              # the display size libavcodec outputs
    height: int
    structure: str          # slice type of each picture, decode order
    md5: tuple              # golden MD5 of each frame, output order

    @property
    def frames(self) -> int:
        return len(self.md5)


def nal_starts(data: bytes) -> list[int]:
    """Where each NAL unit of an Annex-B stream starts: the first byte of
    its start code, with a leading zero byte if it has one."""
    starts, i = [], data.find(b"\x00\x00\x01")
    while i >= 0:
        starts.append(i - 1 if i > 0 and data[i - 1] == 0 else i)
        i = data.find(b"\x00\x00\x01", i + 3)
    return starts


def _payload(data: bytes, start: int) -> int:
    """Offset of the NAL header byte of the unit starting at `start`."""
    return data.index(b"\x00\x00\x01", start) + 3


class _Bits:
    """Exp-Golomb reader over an RBSP prefix."""

    def __init__(self, ebsp: bytes):
        out, zeros = bytearray(), 0
        for b in ebsp:                       # drop emulation prevention
            if zeros >= 2 and b == 3:
                zeros = 0
                continue
            out.append(b)
            zeros = zeros + 1 if b == 0 else 0
        self.bits = "".join(f"{b:08b}" for b in out)
        self.pos = 0

    def ue(self) -> int:
        n = self.bits.index("1", self.pos) - self.pos
        v = int(self.bits[self.pos + n:self.pos + 2 * n + 1], 2) - 1
        self.pos += 2 * n + 1
        return v


def pictures(data: bytes) -> list[tuple[int, str, bool]]:
    """(byte offset where the access unit starts, slice type, IDR) of each
    coded picture, decode order.  An access unit starts at the first
    non-VCL NAL unit after the previous picture's slices, or at a slice
    whose first MB is 0."""
    out, au_start, after_vcl = [], None, True
    for start in nal_starts(data):
        h = _payload(data, start)
        kind = data[h] & 0x1F
        if kind in VCL:
            r = _Bits(data[h + 1:h + 17])
            if r.ue() == 0:                  # first_mb_in_slice
                out.append((start if au_start is None else au_start,
                            SLICE_KIND[r.ue() % 5], kind == IDR))
            au_start, after_vcl = None, True
        elif after_vcl:
            au_start, after_vcl = start, False
    return out


def structure(data: bytes) -> tuple[str, list[int]]:
    """(slice type of each picture in decode order, the IDR pictures'
    decode-order indices)."""
    pics = pictures(data)
    return ("".join(p[1] for p in pics),
            [i for i, p in enumerate(pics) if p[2]])


def truncate(data: bytes, k: int) -> bytes:
    """The stream's first k access units."""
    pics = pictures(data)
    return data if k >= len(pics) else data[:pics[k][0]]


def load_stream(name: str, root: Path = BENCH) -> Stream:
    """Stream `name` of `root`/data, its bytes checked against the
    golden's SHA-256 (a stream edited elsewhere fails here, loudly)."""
    g = json.loads((root / "data" / f"{name}.json").read_text())
    path = root.parent / g["file"]
    data = path.read_bytes()
    if hashlib.sha256(data).hexdigest() != g["sha256"]:
        raise ValueError(f"{path}: bytes differ from the golden's sha256")
    return Stream(name, data, g["width"], g["height"], g["structure"],
                  tuple(g["md5"]))


def lane_orders(n_streams: int, n_lanes: int, seed: int) -> list[list[int]]:
    """Each lane's order of the set's streams (indices), drawn from `seed`
    alone; a lane decodes its order over and over (call_streams)."""
    rng = np.random.default_rng(seed)
    return [[int(k) for k in rng.permutation(n_streams)]
            for _ in range(n_lanes)]


def call_streams(streams: list, order: list[int], call: int,
                 per_call: int) -> list:
    """The streams one lane decodes, joined, in its call number `call`:
    the next `per_call` of its order, which it repeats over and over."""
    m = len(order)
    return [streams[order[(call * per_call + t) % m]]
            for t in range(per_call)]


def warm_pictures(s: Stream) -> int:
    """The shortest prefix of `s` that holds every picture kind it has."""
    return max(s.structure.index(k) for k in set(s.structure)) + 1
