"""Times of the deblock kernels K2 (deblock_phase) and K6 (deblock_raster)
on one GPU, with the MD5 of each output so that two trees' outputs can be
compared byte for byte.

    python tools/deblock_bench.py [--out FILE.json]

Cases, each at 1920x1088 and 3840x2160, on one frame (B = 1) and four
(B = 4): "I", the output of K1 (intra_phase) on chip_smoke.py's synthetic
all-intra frames with their deblock_tables (bS 3/4 on every MB edge);
"P", chip_smoke.py's textured mid-grey planes with the tables of
synthetic_abi_p frames (bS 0..2); "random", random planes with
random_deblock_tables (bS 0..4, tc0 0..25, alpha and beta 0..255).  Each
time is chip_smoke.kernel_ms: launches queued behind a device sleep, the
median of its rounds.  K6's output must equal K2's, and at 1080p, B = 1
the plain version's (ops/deblock.py::deblock_filter_planes); otherwise it
exits non-zero.  Prints one JSON line (with the card's nvidia-smi name
and power limit) and writes it to FILE if --out is given.  Needs a CUDA
device and nvcc.  To compare two trees in one call, copy this script and
arrow_h264_tpu_torch/ops/synthetic.py (for random_deblock_tables) into a
`git archive` of the other tree and run both, in turns.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from arrow_h264_tpu_torch.ops.deblock import (  # noqa: E402
    deblock_filter_planes, deblock_tables,
)
from arrow_h264_tpu_torch.ops.kernels.deblock_phase import (  # noqa: E402
    deblock_phase,
)
from arrow_h264_tpu_torch.ops.kernels.deblock_raster import (  # noqa: E402
    deblock_raster,
)
from arrow_h264_tpu_torch.ops.kernels.intra_phase import (  # noqa: E402
    intra_phase,
)
from arrow_h264_tpu_torch.ops.synthetic import (  # noqa: E402
    random_deblock_tables, synthetic_batch,
)
from arrow_h264_tpu_torch.ops.transforms import (  # noqa: E402
    make_ws_consts, residual_planes,
)
from chip_smoke import (  # noqa: E402
    MB_H, MB_H_4K, MB_W, MB_W_4K, SEED, kernel_ms,
)

KERNELS = {"K2": deblock_phase, "K6": deblock_raster}
SIZES = {"1080p": (MB_W, MB_H), "2160p": (MB_W_4K, MB_H_4K)}


def shapes(mb_w: int, mb_h: int, B: int) -> tuple:
    H, W = mb_h * 16, mb_w * 16
    return (B, H, W), (B, H // 2, W // 2), (B, H // 2, W // 2)


def stack(abis: list) -> dict:
    return {k: torch.cat([x[k] for x in abis]) for k in abis[0]}


def case_i(mb_w: int, mb_h: int, B: int, dev):
    ws4, ws8 = (t.to(dev) for t in make_ws_consts([[16] * 16] * 6,
                                                  [[16] * 64] * 2))
    a = stack([synthetic_batch(mb_w, mb_h, SEED + i, dev)[1]
               for i in range(B)])
    res = residual_planes(a, mb_w, mb_h, ws4, ws8)
    planes = intra_phase(a, *res, None, None, None, mb_w, mb_h)
    return planes, deblock_tables(a, mb_w, mb_h)


def case_p(mb_w: int, mb_h: int, B: int, dev):
    a = stack([synthetic_batch(mb_w, mb_h, SEED + i, dev, inter=True,
                               bi_frac=0.3)[1] for i in range(B)])
    g = torch.Generator(device=dev).manual_seed(SEED)
    planes = tuple(torch.randint(96, 160, s, generator=g, device=dev,
                                 dtype=torch.uint8)
                   for s in shapes(mb_w, mb_h, B))
    return planes, deblock_tables(a, mb_w, mb_h)


def case_random(mb_w: int, mb_h: int, B: int, dev):
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    planes = tuple(torch.randint(0, 256, s, generator=g, device=dev,
                                 dtype=torch.uint8)
                   for s in shapes(mb_w, mb_h, B))
    tables = {k: torch.from_numpy(v).to(dev) for k, v in
              random_deblock_tables(mb_w, mb_h, B, SEED + 5).items()}
    return planes, tables


CASES = {"I": case_i, "P": case_p, "random": case_random}


def md5(planes) -> str:
    h = hashlib.md5()
    for p in planes:
        h.update(p.cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write the JSON line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("deblock_bench: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    out = {"gpu": smi, "ms": {}, "md5": {}}
    for size, (mb_w, mb_h) in SIZES.items():
        for B in (1, 4):
            for name, make in CASES.items():
                case = f"{size}_{name}_b{B}"
                planes, tables = make(mb_w, mb_h, B, dev)
                outs = {k: fn(*(p.clone() for p in planes), tables, mb_w,
                              mb_h) for k, fn in KERNELS.items()}
                if md5(outs["K6"]) != md5(outs["K2"]):
                    sys.exit(f"deblock_bench: {case}: K6 differs from K2")
                if size == "1080p" and B == 1:
                    want = [p.to(torch.uint8) for p in deblock_filter_planes(
                        *planes, tables, mb_w, mb_h)]
                    if md5(want) != md5(outs["K2"]):
                        sys.exit(f"deblock_bench: {case}: K2 differs from "
                                 "the plain version")
                out["md5"][case] = md5(outs["K2"])
                for k, fn in KERNELS.items():
                    work = tuple(p.clone() for p in planes)
                    out["ms"][f"{k}_{case}"] = kernel_ms(
                        lambda: fn(*work, tables, mb_w, mb_h))
                del planes, tables, outs
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
