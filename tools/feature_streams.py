"""The committed feature streams: lossless bypass, CIF configs 2-4, width
classes, FMO/ASO, concealment and dense per-cell weights.

    python tools/feature_streams.py [NAME ...]

writes tests/data/NAME.264 and tests/data/NAME.json for each NAME of
STREAMS (all by default).  Each JSON holds the per-frame MD5s of the
expected output in output order, the picture structure (slice types of
each coded picture in decode order: "I", "P" or "B"), `mc_pictures` (how
many of them have inter MBs once concealed: the pictures that run motion
compensation), the command, the generator call or x264 options, and the
source of the expected output:
- "libavcodec": the system decoder through tools/h264ref (for the FMO
  CAVLC pairs, its decode of the raster twin, which carries the same MBs
  in slices cut at the group rows, since libavcodec has no FMO);
- "pcm_golden": the authored content of an all-I_PCM FMO stream
  (tools/fmo_streams.py);
- "jax_conceal": the JAX package's Decoder(conceal=True) on the CPU,
  for the streams with a dropped slice, which have no golden; their JSON
  also holds `concealed`, the decoder's (frame, MBs repaired) list.
Every stream is also decoded here by the port's Decoder(device="cpu"),
which must equal the expected output (and `concealed`).

The streams need the system libx264/libavcodec (tools/h264ref) and, for
the concealment streams, the JAX package; the machine that only decodes
the committed streams needs none of them.  `stream_bytes(name)` rebuilds
a stream without its golden (tests/test_torch_cli.py checks the small ones
byte for byte).
"""

from __future__ import annotations

import hashlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import streams  # noqa: E402
from tools.fmo_streams import (  # noqa: E402
    SCENARIOS, make_fmo_cavlc_pair, make_fmo_stream, pcm_golden,
)
from tools.wp_streams import make_many_weight_slices_stream  # noqa: E402

DATA = REPO / "tests" / "data"
X = streams.X264_COMMON

# x264 option sets of the JAX package's tests that these streams port
LOSSLESS_CAVLC = ["profile=high444", "qp=0", "g=250", "bf=0", "refs=2",
                  f"x264-params=cabac=0:8x8dct=1:{X}"]
BASELINE_P = ["profile=baseline", "qp=28", "g=250", "bf=0", "refs=1",
              "keyint_min=250", f"x264-params=cabac=0:subme=6:{X}"]
HIGH_CABAC = ["profile=high", "qp=28", "g=250", "bf=1", "refs=2",
              "keyint_min=250",
              f"x264-params=cabac=1:8x8dct=1:weightb=1:b-pyramid=0:{X}"]
# a table-weighted lane of feat_wp18's geometry and stream parameters
# (one reference, chroma QP offsets 0: psy=0 keeps x264 from lowering them)
WP_TABLE = ["profile=main", "qp=26", "g=250", "bf=0", "refs=1",
            "keyint_min=250", f"x264-params=cabac=0:weightp=2:psy=0:{X}"]
CONCEAL_64 = ["profile=high", "qp=26", "g=8", "bf=0", "refs=1",
              "x264-params=cabac=1:slices=2:threads=1"]
# the 1080p smoke stream's settings (config 4) with four slices a picture
# and qp 30
CONCEAL_1080 = [o.replace("qp=26", "qp=30").replace("slices=1", "slices=4")
                for o in streams.CONFIG_OPTS[4]]

# name -> ("x264", (width, height), frames, seed, options, noise, drop)
#       | ("fmo", scenario, slice_order) | ("fmo_cavlc", kind, mb_w, mb_h)
#       | ("wp18",)
# drop: index of the slice NAL cut out of the encoded stream (concealment)
STREAMS = {
    "feat_lossless_qcif": ("x264", (176, 144), 5, 23,
                           streams.CONFIG_OPTS["lossless"], 12, None),
    "feat_lossless_164x132": ("x264", (164, 132), 3, 29, LOSSLESS_CAVLC, 12,
                              None),
    **{f"feat_cif_cfg{c}": ("x264", (352, 288), 4, 60 + c,
                            streams.CONFIG_OPTS[c], 12, None)
       for c in (2, 3, 4)},
    "feat_w512": ("x264", (512, 80), 3, 512, BASELINE_P, 12, None),
    "feat_w976": ("x264", (976, 64), 3, 976, BASELINE_P, 12, None),
    "feat_w512_high": ("x264", (512, 80), 4, 9, HIGH_CABAC, 12, None),
    **{f"feat_fmo_{s}": ("fmo", s, None) for s in sorted(SCENARIOS)},
    "feat_aso": ("fmo", "dispersed_t1", [2, 1, 0]),
    "feat_fmo_cavlc_interleave": ("fmo_cavlc", "interleave", 8, 6),
    "feat_fmo_cavlc_explicit": ("fmo_cavlc", "explicit", 8, 6),
    "feat_fmo1080_interleave": ("fmo_cavlc", "interleave", 120, 68),
    "feat_fmo1080_explicit": ("fmo_cavlc", "explicit", 120, 68),
    # the second slice of picture 1 dropped: picture 0 has 2 (4) slices
    "feat_conceal64": ("x264", (64, 64), 3, 11, CONCEAL_64, 12, 3),
    "feat_conceal1080": ("x264", (1920, 1080), 3, 0, CONCEAL_1080, 3, 5),
    # one reference (2 DPB slots): a BatchDecoder lane beside
    # batch_qcif_s3 (four references, 5 slots)
    "feat_qcif_cfg2": ("x264", (176, 144), 3, 5, streams.CONFIG_OPTS[2], 12,
                       None),
    "feat_wp18": ("wp18",),
    "feat_wp_table": ("x264", (64, 288), 3, 18, WP_TABLE, 12, None),
}
# the streams that the regeneration test leaves out (held by MD5)
LARGE = ("feat_fmo1080_interleave", "feat_fmo1080_explicit",
         "feat_conceal1080")
FMO_FRAMES = 2          # pictures of the all-PCM FMO streams
CAVLC_FRAMES = 3        # pictures of the FMO CAVLC pairs


def _nal_units(data: bytes) -> list[bytes]:
    """The NAL units of an Annex-B stream, each with its start code (and
    a zero byte before it, as a 4-byte start code has)."""
    starts, i = [], 0
    while (j := data.find(b"\x00\x00\x01", i)) >= 0:
        starts.append(j - 1 if j and data[j - 1] == 0 else j)
        i = j + 3
    return [data[a:b] for a, b in zip(starts, starts[1:] + [len(data)])]


def drop_slice(data: bytes, drop: int) -> bytes:
    """The stream without its drop'th slice NAL (types 1 and 5)."""
    out, k = [], 0
    for u in _nal_units(data):
        if (u[u.index(b"\x00\x00\x01") + 3] & 0x1F) in (1, 5):
            k += 1
            if k - 1 == drop:
                continue
        out.append(u)
    return b"".join(out)


def _x264(spec) -> bytes:
    _, (w, h), n, seed, opts, noise, drop = spec
    yuv = streams.make_content(w, h, n, seed=seed, noise=noise)
    with tempfile.TemporaryDirectory() as tmp:
        data = streams.encode(yuv, w, h, str(Path(tmp) / "s.264"), opts)
    return data if drop is None else drop_slice(data, drop)


def stream_bytes(name: str) -> bytes:
    """The committed bytes of stream `name`, rebuilt."""
    spec = STREAMS[name]
    if spec[0] == "x264":
        return _x264(spec)
    if spec[0] == "fmo":
        pps_kwargs, cycle = SCENARIOS[spec[1]]
        return make_fmo_stream(pps_kwargs, n_frames=FMO_FRAMES,
                               change_cycle=cycle, slice_order=spec[2])
    if spec[0] == "fmo_cavlc":
        return make_fmo_cavlc_pair(spec[1], mb_w=spec[2], mb_h=spec[3],
                                   n_frames=CAVLC_FRAMES)[0]
    return make_many_weight_slices_stream(mb_w=4, mb_h=18, n_p=2)


def generator(name: str) -> dict:
    """What made stream `name`, for its JSON."""
    spec = STREAMS[name]
    if spec[0] == "x264":
        _, (w, h), n, seed, opts, noise, drop = spec
        out = {"content": f"streams.make_content({w}, {h}, {n}, seed={seed}, "
                          f"noise={noise})", "x264_opts": opts}
        if drop is not None:
            out["dropped_slice"] = drop
        return out
    if spec[0] == "fmo":
        pps_kwargs, cycle = SCENARIOS[spec[1]]
        return {"generator": f"fmo_streams.make_fmo_stream(SCENARIOS"
                             f"[{spec[1]!r}], n_frames={FMO_FRAMES}, "
                             f"change_cycle={cycle}, "
                             f"slice_order={spec[2]!r})"}
    if spec[0] == "fmo_cavlc":
        return {"generator": f"fmo_streams.make_fmo_cavlc_pair({spec[1]!r}, "
                             f"mb_w={spec[2]}, mb_h={spec[3]}, "
                             f"n_frames={CAVLC_FRAMES})[0]"}
    return {"generator": "wp_streams.make_many_weight_slices_stream(mb_w=4, "
                         "mb_h=18, n_p=2)"}


def expected(name: str, data: bytes) -> tuple[list[np.ndarray], str, dict]:
    """(expected frames as planar bytes, their source, extra JSON keys)."""
    spec = STREAMS[name]
    if spec[0] == "fmo":
        pps_kwargs, cycle = SCENARIOS[spec[1]]
        return (pcm_golden(pps_kwargs, n_frames=FMO_FRAMES,
                           change_cycle=cycle), "pcm_golden", {})
    if spec[0] == "x264" and spec[-1] is not None:
        return _jax_conceal(data)
    if spec[0] == "fmo_cavlc":
        data = make_fmo_cavlc_pair(spec[1], mb_w=spec[2], mb_h=spec[3],
                                   n_frames=CAVLC_FRAMES)[1]
    with tempfile.TemporaryDirectory() as tmp:
        p = Path(tmp) / "s.264"
        p.write_bytes(data)
        golden, _, _ = streams.golden_decode(str(p))
    if spec[0] == "x264" and "qp=0" in spec[4]:
        # lossless: the golden is the encoder's input
        _, (w, h), n, seed, _, noise, _ = spec
        if not np.array_equal(golden, streams.make_content(
                w, h, n, seed=seed, noise=noise)):
            sys.exit(f"{name}: the lossless golden differs from the source")
    source = "libavcodec" if spec[0] != "fmo_cavlc" else \
        "libavcodec decode of the raster twin"
    return list(golden), source, {}


def _jax_conceal(data: bytes):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from arrow_h264_tpu.api import Decoder as JaxDecoder
    dec = JaxDecoder(conceal=True)
    frames = [np.frombuffer(f.planar(), np.uint8)
              for f in dec.decode_annexb(data)]
    return frames, "jax_conceal", {
        "concealed": [list(c) for c in dec.concealed]}


def port_decode(data: bytes, conceal: bool) -> dict:
    """The port's Decoder(device="cpu") on `data`: its frames (planar
    bytes), their size, `concealed`, the structure (module docstring) and
    `mc_pictures`, the pictures that have inter MBs once concealed (those
    launch K3/K4)."""
    from arrow_h264_tpu_torch.api import Decoder
    from arrow_h264_tpu_torch.models.pipeline import DevicePipeline
    from arrow_h264_tpu_torch.ops.abi import KIND_P

    kinds, mc = [], []

    class Recording(Decoder):
        def pack_abi(self, pic, poc):
            kinds.append("B" if any(h.is_b for h in pic.headers) else
                         "P" if any(h.is_p for h in pic.headers) else "I")
            return super().pack_abi(pic, poc)

    orig = DevicePipeline.decode_frame

    def spy(self, abi):
        mc.append(bool((abi["kind"] >= KIND_P).any()))
        return orig(self, abi)

    DevicePipeline.decode_frame = spy
    try:
        dec = Recording(device="cpu", conceal=conceal)
        frames = list(dec.decode_annexb(data))
    finally:
        DevicePipeline.decode_frame = orig
    if not conceal and mc != [k != "I" for k in kinds]:
        sys.exit(f"pictures {kinds}, but inter MBs in {mc}")
    return {"frames": [f.planar() for f in frames],
            "width": frames[0].width, "height": frames[0].height,
            "concealed": [list(c) for c in dec.concealed],
            "structure": "".join(kinds), "mc_pictures": sum(mc)}


def write_stream(name: str) -> None:
    data = stream_bytes(name)
    frames, source, extra = expected(name, data)
    md5 = [hashlib.md5(np.asarray(f).tobytes()).hexdigest() for f in frames]
    conceal = "concealed" in extra
    ours = port_decode(data, conceal)
    if [hashlib.md5(f).hexdigest() for f in ours["frames"]] != md5:
        sys.exit(f"{name}: the port's CPU decode differs from {source}")
    if conceal and ours["concealed"] != extra["concealed"]:
        sys.exit(f"{name}: the port concealed {ours['concealed']}, the JAX "
                 f"package {extra['concealed']}")
    path = DATA / f"{name}.264"
    path.write_bytes(data)
    w, h = ours["width"], ours["height"]
    path.with_suffix(".json").write_text(json.dumps({
        "command": f"python tools/feature_streams.py {name}",
        **generator(name), "expected": source,
        "structure": ours["structure"], "mc_pictures": ours["mc_pictures"],
        "width": w, "height": h,
        "frames": len(md5), **extra, "md5": md5,
    }, indent=1) + "\n")
    print(f"{path.relative_to(REPO)}: {len(data)} bytes, {len(md5)} frames "
          f"{w}x{h}, expected output: {source}")


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
