"""The committed conformance streams: one a config of
tools/tpu_conformance.py (QCIF to 3840x2160), the second lane of a 4K
batch, and two 720p lanes of several GOPs each.

    python tools/conformance_streams.py [NAME ...]

writes tests/data/NAME.264 and tests/data/NAME.json for each NAME of
STREAMS (all by default).  conf_c1..conf_c6 are the streams of configs
1-6 (the resolutions, frame counts, x264 options and seeds 40 + config of
tools/tpu_conformance.py; config 5 is 3840x2160 High, config 6 CIF
lossless), with the content's noise cut from 12 to 3 on configs 4 and 5
to keep the files small.  batch_2160p_s1 is a second 4K lane, one frame
shorter than conf_c5, so that the lanes of a 4K BatchDecoder differ and
end in different rounds.  gop_720p_s0/s1 are 8-frame lanes with the x264
options of tests/test_batch_binding_shape.py and IDRs every 6 and every
4 frames (that test's lanes have 20 frames, an IDR every 10): two GOPs a
lane, and lockstep rounds that put an IDR lane beside a P/B lane.  To
keep all nine under 12 MB, the GOP lanes have 8 frames, not 12 (an I
picture is ~370 KB of a lane's ~1 MB), and the second 4K lane is coded
at qp 40, not 34 (1.6 MB, not 2.9).  Each JSON's `cuts` lists the cuts
of its stream.

Each JSON holds the per-frame MD5 of libavcodec's decode in output order,
the structure (each coded picture's slice type in decode order, "I", "P"
or "B"), the decode-order indices of the IDR pictures, the content call,
the x264 options and the command.  The streams need the system
libx264/libavcodec through tools/h264ref; the machine that only decodes
the committed streams needs neither.  `stream_bytes(name)` rebuilds a
stream without its golden (tests/test_torch_conformance.py checks each
byte for byte).
"""

from __future__ import annotations

import hashlib
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from arrow_h264_tpu_torch.bitstream import nal  # noqa: E402
from arrow_h264_tpu_torch.bitstream.bits import BitReader  # noqa: E402
from tools import streams  # noqa: E402

DATA = REPO / "tests" / "data"
X = streams.X264_COMMON


def binding_opts(gop: int) -> list[str]:
    """The x264 options of tests/test_batch_binding_shape.py's lanes with
    an IDR every `gop` frames."""
    return ["profile=high", "qp=30", f"g={gop}", "bf=2", "refs=3",
            f"keyint_min={gop}",
            "x264-params=cabac=1:8x8dct=1:weightp=2:weightb=1:b-pyramid=0:"
            + X]


# name -> ((width, height), frames, x264 options, seed, noise)
STREAMS = {
    "conf_c1": ((176, 144), 3, streams.CONFIG_OPTS[1], 41, 12),
    "conf_c2": ((352, 288), 5, streams.CONFIG_OPTS[2], 42, 12),
    "conf_c3": ((1280, 720), 5, streams.CONFIG_OPTS[3], 43, 12),
    "conf_c4": ((1920, 1088), 5, streams.CONFIG_OPTS[4], 44, 3),
    "conf_c5": ((3840, 2160), 3, streams.CONFIG_OPTS[4], 45, 3),
    "conf_c6": ((352, 288), 4, streams.CONFIG_OPTS["lossless"], 46, 12),
    "batch_2160p_s1": ((3840, 2160), 2,
                       [o.replace("qp=26", "qp=40")
                        for o in streams.CONFIG_OPTS[4]], 47, 3),
    "gop_720p_s0": ((1280, 720), 8, binding_opts(6), 300, 3),
    "gop_720p_s1": ((1280, 720), 8, binding_opts(4), 301, 3),
}
# the cuts of each stream against its source, for its JSON
NOISE_CUT = "content noise 3, not tools/tpu_conformance.py's 12"
GOP_CUT = ("8 frames, not the 20 of tests/test_batch_binding_shape.py "
           "(repo size)")
CUTS = {"conf_c4": [NOISE_CUT], "conf_c5": [NOISE_CUT],
        "batch_2160p_s1": ["qp 40, not 34 (repo size)"],
        "gop_720p_s0": [GOP_CUT], "gop_720p_s1": [GOP_CUT]}
SLICE_KIND = "PBI"             # slice_type % 5: P 0, B 1, I 2


def stream_bytes(name: str) -> bytes:
    """The committed bytes of stream `name`, rebuilt."""
    (w, h), n, opts, seed, noise = STREAMS[name]
    yuv = streams.make_content(w, h, n, seed=seed, noise=noise)
    with tempfile.TemporaryDirectory() as tmp:
        return streams.encode(yuv, w, h, str(Path(tmp) / "s.264"), opts)


def structure(data: bytes) -> tuple[str, list[int]]:
    """(the slice type of each coded picture in decode order, the
    decode-order indices of the IDR pictures), from the slice headers'
    first fields (a picture starts with the slice whose first MB is 0)."""
    kinds, idr = "", []
    for u in nal.parse_annexb(data):
        if not u.is_slice:
            continue
        r = BitReader(u.rbsp)
        if r.ue() == 0:                          # first_mb_in_slice
            if u.is_idr:
                idr.append(len(kinds))
            kinds += SLICE_KIND[r.ue() % 5]
    return kinds, idr


def write_stream(name: str) -> None:
    (w, h), n, opts, seed, noise = STREAMS[name]
    data = stream_bytes(name)
    path = DATA / f"{name}.264"
    path.write_bytes(data)
    golden, gw, gh = streams.golden_decode(str(path))
    kinds, idr = structure(data)
    path.with_suffix(".json").write_text(json.dumps({
        "command": f"python tools/conformance_streams.py {name}",
        "content": f"streams.make_content({w}, {h}, {n}, seed={seed}, "
                   f"noise={noise})",
        "x264_opts": opts, "cuts": CUTS.get(name, []),
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


if __name__ == "__main__":
    main()
