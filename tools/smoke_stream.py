"""Generate the committed test streams and their golden frame hashes.

    python tools/smoke_stream.py [NAME ...]

writes tests/data/NAME.264 and tests/data/NAME.json for each NAME of
STREAMS (all of them by default).  Each is synthetic content
(`streams.make_content(..., noise=3)` from the stream's seed) encoded with
libx264 at config 4: High profile, CABAC, 8x8 transform, weighted P/B,
B-frames, 4 references.  smoke_1080p_high (1920x1080, 6 frames, seed 0)
is the single-stream smoke stream; batch_1080p_s1..s3 (6, 5 and 4 frames,
seeds 1..3) join it as the lanes of chip_smoke.py's batch phase, so that
lanes end in different rounds; batch_qcif_s1..s4 (176x144, 3, 4, 5 and 3
frames) are the small lanes of the batch tests, on the CPU and on the
card.  The JSON holds the per-frame MD5 of libavcodec's decode in output
order, plus the command that made them.  It needs the system
libx264/libavcodec through tools/h264ref; the machine that only decodes
the committed streams needs neither.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import streams  # noqa: E402

DATA = REPO / "tests" / "data"
NOISE, CONFIG = 3, 4
HD, QCIF = (1920, 1080), (176, 144)
# name -> ((width, height), frames, seed)
STREAMS = {"smoke_1080p_high": (HD, 6, 0), "batch_1080p_s1": (HD, 6, 1),
           "batch_1080p_s2": (HD, 5, 2), "batch_1080p_s3": (HD, 4, 3),
           "batch_qcif_s1": (QCIF, 3, 11), "batch_qcif_s2": (QCIF, 4, 12),
           "batch_qcif_s3": (QCIF, 5, 13), "batch_qcif_s4": (QCIF, 3, 14)}


def frame_md5s(frames) -> list[str]:
    return [hashlib.md5(f.tobytes()).hexdigest() for f in frames]


def write_stream(name: str) -> None:
    (W, H), n_frames, seed = STREAMS[name]
    stream = DATA / f"{name}.264"
    yuv = streams.make_content(W, H, n_frames, seed=seed, noise=NOISE)
    streams.encode(yuv, W, H, str(stream), streams.CONFIG_OPTS[CONFIG])
    golden, gw, gh = streams.golden_decode(str(stream))
    command = "python tools/smoke_stream.py"
    if name != "smoke_1080p_high":
        command += f" {name}"
    stream.with_suffix(".json").write_text(json.dumps({
        "command": command,
        "content": f"streams.make_content({W}, {H}, {n_frames}, "
                   f"seed={seed}, noise={NOISE})",
        "x264_opts": streams.CONFIG_OPTS[CONFIG],
        "width": gw, "height": gh, "frames": int(golden.shape[0]),
        "md5": frame_md5s(golden),
    }, indent=1) + "\n")
    print(f"{stream.relative_to(REPO)}: {stream.stat().st_size} bytes, "
          f"{golden.shape[0]} frames {gw}x{gh}")


def main() -> None:
    names = sys.argv[1:] or list(STREAMS)
    unknown = set(names) - set(STREAMS)
    if unknown:
        sys.exit(f"unknown stream(s) {sorted(unknown)}: expected "
                 f"{sorted(STREAMS)}")
    for name in names:
        write_stream(name)


if __name__ == "__main__":
    main()
