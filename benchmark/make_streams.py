"""The benchmark's goldens: benchmark/data/NAME.json for every stream a
cell uses.

    python benchmark/make_streams.py [NAME ...]

Needs the system libavcodec through tools/h264ref, so it runs where it
is, never on the card; a run of the benchmark reads only what it wrote.

The streams are committed in tests/data (bench_broadcast_s0..s3,
conf_c5) and keep their bytes there; their golden here copies the MD5s,
structure and size of their tests/data JSON (checked by decoding the
bytes with libavcodec again) and adds the bytes' SHA-256.
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
from tools import streams  # noqa: E402

DATA = BENCH / "data"
COMMITTED = ("bench_broadcast_s0", "bench_broadcast_s1", "bench_broadcast_s2",
             "bench_broadcast_s3", "conf_c5")


def md5s(path: Path) -> list[str]:
    golden, _, _ = streams.golden_decode(str(path))
    return [hashlib.md5(f.tobytes()).hexdigest() for f in golden]


def write_committed(name: str) -> None:
    src = REPO / "tests" / "data" / f"{name}.json"
    meta = json.loads(src.read_text())
    rel = f"tests/data/{name}.264"
    data = (REPO / rel).read_bytes()
    if md5s(REPO / rel) != meta["md5"]:
        raise SystemExit(f"{name}: libavcodec disagrees with {src.name}")
    kinds, idr = structure(data)
    if len(kinds) != len(meta["md5"]):
        raise SystemExit(f"{name}: {len(kinds)} pictures, "
                         f"{len(meta['md5'])} frames")
    out = {"file": rel, "sha256": hashlib.sha256(data).hexdigest(),
           "bytes": len(data), "width": meta["width"],
           "height": meta["height"], "frames": len(meta["md5"]),
           "structure": kinds, "idr": idr,
           "source": meta.get("source", meta["command"]),
           "command": "python benchmark/make_streams.py " + name,
           "content": meta["content"], "x264_opts": meta["x264_opts"],
           "cuts": meta["cuts"], "md5": meta["md5"]}
    (DATA / f"{name}.json").write_text(json.dumps(out, indent=1) + "\n")
    print(f"{name}: {len(data)} bytes, {kinds} (IDR at {idr})")


def main() -> None:
    names = sys.argv[1:] or list(COMMITTED)
    unknown = set(names) - set(COMMITTED)
    if unknown:
        raise SystemExit(f"unknown stream(s) {sorted(unknown)}")
    for name in names:
        write_committed(name)


if __name__ == "__main__":
    main()
