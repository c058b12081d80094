"""The committed stream sets of the port's bench (arrow_h264_tpu_torch.bench
--streams broadcast|adversarial): the JAX package's bench.py broadcast
streams and bench_host.py's adversarial stream.

    python tools/bench_streams.py [NAME ...]

writes tests/data/NAME.264 and tests/data/NAME.json for each NAME of
STREAMS (all by default).  bench_broadcast_s0..s3 are bench.py's
make_streams (bench.py:66-79): 1920x1088, 12 frames,
`streams.make_content(..., seed=100 + s, noise=3)`, High, CABAC, qp 30, 2
B-frames, 4 references, weighted P/B, one IDR (g=250, keyint_min=250).
bench_adversarial is bench_host.py's adversarial stream (bench_host.py:
80-83): 1920x1088, 8 frames, `make_content(..., seed=7)` at its default
noise of 12, `streams.CONFIG_OPTS[4]` (qp 26), the worst-case CABAC bin
density.  No stream departs from its source (each JSON's `cuts` is
empty).  bench_host.py's broadcast stream (16 frames, seed 100) has the
content recipe of bench_broadcast_s0 with 4 more frames and is not
committed: the port's bench measures broadcast's host parse as
`host_parse_fps --streams broadcast`, over the four streams.

Each JSON holds the per-frame MD5 of libavcodec's decode in output order,
the structure (each coded picture's slice type in decode order), the
decode-order indices of the IDR pictures, the content call, the x264
options, the source and the command, as tools/conformance_streams.py
writes them.  The streams need the system libx264/libavcodec through
tools/h264ref; the machine that only decodes the committed streams needs
neither.  `stream_bytes(name)` rebuilds a stream without its golden.
"""

from __future__ import annotations

import hashlib
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import streams  # noqa: E402
from tools.conformance_streams import structure  # noqa: E402

DATA = REPO / "tests" / "data"
W, H = 1920, 1088
# bench.py:73-76 (and bench_host.py:90-93)
BROADCAST_OPTS = ["profile=high", "qp=30", "g=250", "bf=2", "refs=4",
                  "keyint_min=250",
                  "x264-params=cabac=1:8x8dct=1:weightp=2:weightb=1:"
                  "b-pyramid=0:" + streams.X264_COMMON]
# name -> (frames, x264 options, seed, noise, source)
STREAMS = {
    **{f"bench_broadcast_s{s}": (12, BROADCAST_OPTS, 100 + s, 3,
                                 "bench.py:66-79 (make_streams)")
       for s in range(4)},
    "bench_adversarial": (8, streams.CONFIG_OPTS[4], 7, 12,
                          "bench_host.py:80-83 (adversarial)"),
}
BUDGET = 12 * 10 ** 6          # bytes the two sets may add to tests/data


def stream_bytes(name: str) -> bytes:
    """The committed bytes of stream `name`, rebuilt."""
    n, opts, seed, noise, _ = STREAMS[name]
    yuv = streams.make_content(W, H, n, seed=seed, noise=noise)
    with tempfile.TemporaryDirectory() as tmp:
        return streams.encode(yuv, W, H, str(Path(tmp) / "s.264"), opts)


def write_stream(name: str) -> None:
    n, opts, seed, noise, source = STREAMS[name]
    data = stream_bytes(name)
    path = DATA / f"{name}.264"
    path.write_bytes(data)
    golden, gw, gh = streams.golden_decode(str(path))
    kinds, idr = structure(data)
    path.with_suffix(".json").write_text(json.dumps({
        "command": f"python tools/bench_streams.py {name}",
        "source": source,
        "content": f"streams.make_content({W}, {H}, {n}, seed={seed}, "
                   f"noise={noise})",
        "x264_opts": opts, "cuts": [],
        "structure": kinds, "idr": idr,
        "width": gw, "height": gh, "frames": int(golden.shape[0]),
        "md5": [hashlib.md5(f.tobytes()).hexdigest() for f in golden],
    }, indent=1) + "\n")
    print(f"{path.relative_to(REPO)}: {len(data)} bytes, {golden.shape[0]} "
          f"frames {gw}x{gh}, {kinds} (IDR at {idr})")


def main() -> None:
    names = sys.argv[1:] or list(STREAMS)
    unknown = set(names) - set(STREAMS)
    if unknown:
        sys.exit(f"unknown stream(s) {sorted(unknown)}: expected "
                 f"{sorted(STREAMS)}")
    for name in names:
        write_stream(name)
    total = sum((DATA / f"{n}{ext}").stat().st_size for n in STREAMS
                for ext in (".264", ".json") if (DATA / f"{n}{ext}").exists())
    print(f"the bench sets: {total} bytes of {BUDGET}")
    if total > BUDGET:
        sys.exit("over the size budget")


if __name__ == "__main__":
    main()
