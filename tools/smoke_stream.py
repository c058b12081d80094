"""Generate the committed 1080p smoke stream and its golden frame hashes.

    python tools/smoke_stream.py

writes tests/data/smoke_1080p_high.264 (6 frames of 1920x1080 synthetic
content encoded with libx264 at config 4: High profile, CABAC, 8x8
transform, weighted P/B, B-frames, 4 references) and
tests/data/smoke_1080p_high.json (per-frame MD5 of libavcodec's decode in
output order, plus the command that made them).  It needs the system
libx264/libavcodec through tools/h264ref; the machine that only decodes
the committed stream needs neither.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import streams  # noqa: E402

STREAM = REPO / "tests" / "data" / "smoke_1080p_high.264"
GOLDEN = STREAM.with_suffix(".json")
W, H, N_FRAMES, SEED, NOISE, CONFIG = 1920, 1080, 6, 0, 3, 4


def frame_md5s(frames) -> list[str]:
    return [hashlib.md5(f.tobytes()).hexdigest() for f in frames]


def main() -> None:
    yuv = streams.make_content(W, H, N_FRAMES, seed=SEED, noise=NOISE)
    streams.encode(yuv, W, H, str(STREAM), streams.CONFIG_OPTS[CONFIG])
    golden, gw, gh = streams.golden_decode(str(STREAM))
    GOLDEN.write_text(json.dumps({
        "command": "python tools/smoke_stream.py",
        "content": f"streams.make_content({W}, {H}, {N_FRAMES}, "
                   f"seed={SEED}, noise={NOISE})",
        "x264_opts": streams.CONFIG_OPTS[CONFIG],
        "width": gw, "height": gh, "frames": int(golden.shape[0]),
        "md5": frame_md5s(golden),
    }, indent=1) + "\n")
    print(f"{STREAM.relative_to(REPO)}: {STREAM.stat().st_size} bytes, "
          f"{golden.shape[0]} frames {gw}x{gh}")


if __name__ == "__main__":
    main()
