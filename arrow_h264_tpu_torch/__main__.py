"""Command-line decoder of the PyTorch port.

    python -m arrow_h264_tpu_torch decode IN.264 OUT.yuv [--ref GOLDEN.yuv]
        [--psnr] [--entropy cpp|python] [--trace T.jsonl] [--trace-se SE.txt]
        [--device cuda|cpu] [--order phase|raster]
    python -m arrow_h264_tpu_torch info IN.264

`decode` writes planar YUV 4:2:0 in output order and, with --ref, compares
every frame byte for byte: the exit code is 0 when the output is
bit-exact, 1 on a mismatch, a truncated reference or a reference with
more frames than the stream.  The decode runs on --device (default cuda:
without a card the Decoder raises, there is no fallback; cpu runs the
plain PyTorch versions of the kernels) with the intra and deblock kernels
of --order.  `info` prints the stream's NAL structure.  The subcommands
and flags are those of the JAX package's CLI, plus --device and --order.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from contextlib import ExitStack

import numpy as np

from .api import Decoder
from .bitstream import nal
from .bitstream.params import parse_sps
from .models.pipeline import ORDERS


def _cmd_decode(args: argparse.Namespace) -> int:
    data = open(args.input, "rb").read()
    n = w = h = 0
    mismatches = 0
    sse = [0.0, 0.0, 0.0]       # per plane, for --psnr (JM-style SNR line)
    npx = [0, 0, 0]
    with ExitStack() as files:
        trace, trace_se = (files.enter_context(open(p, "a")) if p else None
                           for p in (args.trace, args.trace_se))
        ref = files.enter_context(open(args.ref, "rb")) if args.ref else None
        out = files.enter_context(open(args.output, "wb"))
        dec = Decoder(device=args.device, entropy=args.entropy, trace=trace,
                      trace_se=trace_se, order=args.order)
        t0 = time.perf_counter()
        for frame in dec.decode_annexb(data):
            buf = frame.planar()
            out.write(buf)
            if ref is not None:
                want = ref.read(len(buf))
                if len(want) != len(buf):
                    print(f"frame {n}: reference truncated "
                          f"({len(want)} of {len(buf)} bytes)",
                          file=sys.stderr)
                    mismatches += 1
                else:
                    if want != buf:
                        diffs = np.count_nonzero(
                            np.frombuffer(buf, np.uint8)
                            != np.frombuffer(want, np.uint8))
                        print(f"frame {n}: {diffs} byte diffs vs "
                              f"{args.ref}", file=sys.stderr)
                        mismatches += 1
                    if args.psnr:
                        a = np.frombuffer(buf, np.uint8).astype(np.int64)
                        b = np.frombuffer(want, np.uint8).astype(np.int64)
                        ny = frame.width * frame.height
                        for pl, (o, ln) in enumerate(
                                ((0, ny), (ny, ny // 4),
                                 (ny + ny // 4, ny // 4))):
                            d = a[o:o + ln] - b[o:o + ln]
                            sse[pl] += float((d * d).sum())
                            npx[pl] += ln
            n += 1
            w, h = frame.width, frame.height
        dt = time.perf_counter() - t0
        extra = ref.read(1) if ref is not None else b""
    print(f"decoded {n} frames {w}x{h} in {dt:.2f}s "
          f"({n / max(dt, 1e-9):.1f} fps on {dec.device}, order "
          f"{dec.order}, incl. host entropy)")
    if ref is None:
        return 0
    if args.psnr:
        vals = ["n/a" if not npx[pl] else "inf" if not sse[pl] else
                f"{10 * math.log10(255 * 255 * npx[pl] / sse[pl]):.2f}"
                for pl in range(3)]
        print(f"SNR Y {vals[0]} dB  U {vals[1]} dB  V {vals[2]} dB")
    if extra:
        print("reference YUV has more frames than the stream",
              file=sys.stderr)
        return 1
    if mismatches:
        return 1
    print("bit-exact vs reference YUV")
    return 0


def _cmd_info(args: argparse.Namespace) -> int:
    data = open(args.input, "rb").read()
    counts: dict[int, int] = {}
    for u in nal.parse_annexb(data):
        counts[u.nal_unit_type] = counts.get(u.nal_unit_type, 0) + 1
        if u.nal_unit_type == nal.NAL_SPS:
            s = parse_sps(u.rbsp)
            print(f"SPS {s.seq_parameter_set_id}: profile {s.profile_idc} "
                  f"level {s.level_idc} {s.pic_width_in_mbs * 16}x"
                  f"{s.pic_height_in_map_units * 16} "
                  f"(crop -> {s.width}x{s.height})")
    names = {1: "slice", 5: "IDR", 6: "SEI", 7: "SPS", 8: "PPS", 9: "AUD",
             12: "filler"}
    for t in sorted(counts):
        print(f"  nal type {t} ({names.get(t, '?')}): {counts[t]}")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="arrow_h264_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("decode", help="decode Annex-B to planar YUV420")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--ref", help="reference YUV to compare bit-exactly")
    d.add_argument("--psnr", action="store_true",
                   help="with --ref: print per-plane SNR (JM-style)")
    d.add_argument("--entropy", choices=("cpp", "python"), default="cpp")
    d.add_argument("--trace", help="write per-slice/per-MB JSONL decode trace")
    d.add_argument("--trace-se", dest="trace_se",
                   help="write the syntax-element-level entropy trace "
                        "(JM trace_dec.txt analog)")
    d.add_argument("--device", default="cuda",
                   help="torch device of the reconstruction (default cuda; "
                        "cpu runs the kernels' plain versions)")
    d.add_argument("--order", choices=sorted(ORDERS), default="phase",
                   help="intra and deblock kernels: knight-move wavefront "
                        "(phase) or raster order (raster)")
    d.set_defaults(fn=_cmd_decode)
    i = sub.add_parser("info", help="print stream structure")
    i.add_argument("input")
    i.set_defaults(fn=_cmd_info)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
