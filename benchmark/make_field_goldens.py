"""The goldens of the benchmark's field streams: benchmark/data/NAME.json
for each 1080i stream a cell uses, in make_streams.py's format.

    python benchmark/make_field_goldens.py [NAME ...]

The streams are all-field PAFF, written by tools/field_cabac.py (x264
cannot emit field pictures) and committed in tests/data with its JSON;
their golden here copies that JSON's MD5s (checked by decoding the bytes
with libavcodec again, through tools/h264ref, so this runs where
libavcodec is, never on the card) and adds the bytes' SHA-256.  `structure` is one
letter a coded picture, as lanes.structure reads the bytes: a field
each, two a woven frame, so a stream has twice as many letters as
frames and MD5s.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
sys.path.insert(0, str(REPO))

from benchmark.lanes import structure  # noqa: E402
from benchmark.make_streams import md5s  # noqa: E402

DATA = BENCH / "data"
FIELD_STREAMS = tuple(f"bench_field1080i_s{s}" for s in range(4))


def write_golden(name: str) -> None:
    src = REPO / "tests" / "data" / f"{name}.json"
    meta = json.loads(src.read_text())
    rel = f"tests/data/{name}.264"
    data = (REPO / rel).read_bytes()
    if md5s(REPO / rel) != meta["md5"]:
        raise SystemExit(f"{name}: libavcodec disagrees with {src.name}")
    kinds, idr = structure(data)
    if kinds != meta["structure"] or len(kinds) != 2 * len(meta["md5"]):
        raise SystemExit(f"{name}: {len(kinds)} field pictures {kinds}, "
                         f"{len(meta['md5'])} frames")
    out = {"file": rel, "sha256": hashlib.sha256(data).hexdigest(),
           "bytes": len(data), "width": meta["width"],
           "height": meta["height"], "frames": len(meta["md5"]),
           "structure": kinds, "idr": idr,
           "source": meta["command"],
           "command": "python benchmark/make_field_goldens.py " + name,
           "content": meta["content"], "x264_opts": [],
           "cuts": [], "md5": meta["md5"]}
    (DATA / f"{name}.json").write_text(json.dumps(out, indent=1) + "\n")
    print(f"{name}: {len(data)} bytes, {kinds} (IDR at {idr})")


def main() -> None:
    names = sys.argv[1:] or list(FIELD_STREAMS)
    unknown = set(names) - set(FIELD_STREAMS)
    if unknown:
        raise SystemExit(f"unknown stream(s) {sorted(unknown)}")
    for name in names:
        write_golden(name)


if __name__ == "__main__":
    main()
