"""Times of the deblocking-table kernel K7 (deblock_tables) and the wire
unpack kernel K12 (unpack_wire, alone: bm8=False) on one GPU, with the
MD5 of each output so that two trees' outputs can be compared byte for
byte.

    python tools/tables_wire_bench.py [--out FILE.json]

K7 cases, each at 1920x1088 and 3840x2160, on one picture (B = 1) and
four (B = 4): "p", chip_smoke.py's synthetic_abi_p frames (its phase 3
figures); "random", random_deblock_abi (every deblocking rule);
"field", the synthetic_abi_p frames as field pictures.  K12 cases: the
wire rounds (chip_smoke.wire_round) of the smoke stream's picture 1 (B =
1) and of its pictures 1-4 as four lanes (B = 4), of conf_c5's picture 1
(3840x2160, B = 1) and of the uhd round (conf_c5's picture 1 in four
lanes).  Every output must equal its plain version (torch.equal), or the
script exits non-zero.  Each time is chip_smoke.kernel_ms: launches
queued behind a device sleep, the median of its rounds; each bound is
chip_smoke's (bytes over 3.35 TB/s).  Prints one JSON line (with the
card's nvidia-smi name and power limit) and writes it to FILE if --out
is given.  Needs a CUDA device and nvcc.  To compare two trees in one
call, copy this script into a `git archive` of the other tree and run
both, in turns.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from functools import partial
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from arrow_h264_tpu_torch.ops.deblock import (  # noqa: E402
    deblock_tables as tables_plain,
)
from arrow_h264_tpu_torch.ops.kernels.deblock_tables import (  # noqa: E402
    deblock_tables,
)
from arrow_h264_tpu_torch.ops.kernels.unpack_wire import (  # noqa: E402
    unpack_wire,
)
from arrow_h264_tpu_torch.ops.synthetic import (  # noqa: E402
    random_deblock_abi, synthetic_batch,
)
from arrow_h264_tpu_torch.ops.wire import unpack_wire_plain  # noqa: E402
from chip_smoke import (  # noqa: E402
    MB_H, MB_H_4K, MB_W, MB_W_4K, SEED, STREAM, bound, kernel_ms,
    stream_abis, tables_need, unpack_need, wire_round,
)

SIZES = {"1080p": (MB_W, MB_H), "2160p": (MB_W_4K, MB_H_4K)}
CQP = (2, -3)


def k7_cases(dev):
    """(name, abi, mb_w, mb_h, field) of every K7 case, made one size
    and B at a time."""
    for size, (mb_w, mb_h) in SIZES.items():
        for B in (1, 4):
            lanes = [synthetic_batch(mb_w, mb_h, SEED + 50 + i, dev,
                                     inter=True, bi_frac=0.3)[1]
                     for i in range(B)]
            p = {k: torch.cat([x[k] for x in lanes]) for k in lanes[0]}
            r = {k: torch.from_numpy(v).to(dev) for k, v in
                 random_deblock_abi(mb_w, mb_h, B, SEED + 51).items()}
            for name, a, field in (("p", p, False), ("random", r, False),
                                   ("field", p, True)):
                yield f"K7_{size}_{name}_b{B}", a, mb_w, mb_h, field


def k12_cases(dev):
    """(name, buf, mb_w, mb_h, spec) of every K12 case."""
    smoke, _ = stream_abis(STREAM.read_bytes(), dev)
    uhd, _ = stream_abis((STREAM.parent / "conf_c5.264").read_bytes(), dev)
    for name, abis, mb_w, mb_h in (
            ("K12_1080p_b1", smoke[1:2], MB_W, MB_H),
            ("K12_1080p_b4", smoke[1:5], MB_W, MB_H),
            ("K12_2160p_b1", uhd[1:2], MB_W_4K, MB_H_4K),
            ("K12_2160p_b4", [uhd[1]] * 4, MB_W_4K, MB_H_4K)):
        buf, spec, _ = wire_round(abis, mb_w, mb_h, dev)
        yield name, buf, mb_w, mb_h, spec


def md5(tables: dict) -> str:
    h = hashlib.md5()
    for k in sorted(tables):
        h.update(k.encode())
        h.update(tables[k].contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def same(name: str, got: dict, want: dict) -> None:
    """Exit unless got equals want key by key (torch.equal)."""
    if set(got) != set(want) or not all(torch.equal(got[k], want[k])
                                        for k in want):
        sys.exit(f"tables_wire_bench: {name} differs from the plain "
                 "version")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write the JSON line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tables_wire_bench: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    out = {"gpu": smi, "ms": {}, "bound_ms": {}, "md5": {}}
    for name, a, mb_w, mb_h, field in k7_cases(dev):
        call = partial(deblock_tables, a, mb_w, mb_h, CQP, field)
        got = call()
        same(name, got, tables_plain(a, mb_w, mb_h, CQP, field))
        out["md5"][name] = md5(got)
        out["ms"][name] = kernel_ms(call)
        out["bound_ms"][name] = bound(*tables_need(a, got))[0]
    for name, buf, mb_w, mb_h, spec in k12_cases(dev):
        call = partial(unpack_wire, buf, mb_w, mb_h, spec, bm8=False)
        got = call()
        want = unpack_wire_plain(buf, mb_w, mb_h, spec)
        same(name, got, {k: want[k] for k in got})
        out["md5"][name] = md5(got)
        out["ms"][name] = kernel_ms(call)
        out["bound_ms"][name] = bound(*unpack_need(buf, mb_w * mb_h, spec,
                                                   got))[0]
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
