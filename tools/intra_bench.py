"""Times of the intra kernels K1 (intra_phase) and K5 (intra_raster) on
one GPU, at the shapes of chip_smoke.py's checks, with the MD5 of each
output so that two trees' outputs can be compared byte for byte.

    python tools/intra_bench.py [--out FILE.json]

Cases: chip_smoke.py's synthetic all-intra 1080p frame (half I4x4, half
I16x16 MBs) at B = 1 and four such frames (B = 4); random_intra_abi at
1080p (every MB kind, random modes and availability, inter MBs read from
random init planes); the synthetic frame at 3840x2160, B = 1 and B = 4.
Each time is chip_smoke.kernel_ms: launches queued behind a device
sleep, the median of its rounds.  K5's output must equal K1's, and at
1080p B = 1 the plain version's (ops/intra.py); otherwise it exits
non-zero.  Prints one JSON line (with the card's nvidia-smi name and
power limit) and writes it to FILE if --out is given.  Needs a CUDA
device and nvcc.
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

from arrow_h264_tpu_torch.ops.intra import intra_reconstruct  # noqa: E402
from arrow_h264_tpu_torch.ops.kernels.intra_phase import (  # noqa: E402
    intra_phase,
)
from arrow_h264_tpu_torch.ops.kernels.intra_raster import (  # noqa: E402
    intra_raster,
)
from arrow_h264_tpu_torch.ops.synthetic import (  # noqa: E402
    random_intra_abi, synthetic_batch,
)
from arrow_h264_tpu_torch.ops.transforms import (  # noqa: E402
    make_ws_consts, residual_planes,
)
from chip_smoke import (  # noqa: E402
    MB_H, MB_H_4K, MB_W, MB_W_4K, SEED, kernel_ms,
)

KERNELS = {"K1": intra_phase, "K5": intra_raster}


def synthetic(mb_w: int, mb_h: int, B: int, dev):
    ws4, ws8 = (t.to(dev) for t in make_ws_consts([[16] * 16] * 6,
                                                  [[16] * 64] * 2))
    batch = [synthetic_batch(mb_w, mb_h, SEED + i, dev)[1] for i in range(B)]
    a = {k: torch.cat([x[k] for x in batch]) for k in batch[0]}
    return (a, *residual_planes(a, mb_w, mb_h, ws4, ws8), None, None, None,
            mb_w, mb_h)


def random_abi(mb_w: int, mb_h: int, dev):
    """random_intra_abi over random init planes, as chip_smoke.py's."""
    ra = {k: torch.from_numpy(v).to(dev)[None]
          for k, v in random_intra_abi(mb_w, mb_h, SEED + 4).items()}
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    H, W = mb_h * 16, mb_w * 16
    shapes = ((1, H, W), (1, H // 2, W // 2), (1, H // 2, W // 2))
    pcm = (ra["kind"].view(1, mb_h, mb_w) == 3) \
        .repeat_interleave(16, 1).repeat_interleave(16, 2)
    res = [torch.randint(-300, 300, s, generator=g, device=dev,
                         dtype=torch.int32) for s in shapes]
    res = [torch.where(m, r.remainder(256), r)
           for r, m in zip(res, (pcm, pcm[:, ::2, ::2], pcm[:, ::2, ::2]))]
    init = [torch.randint(0, 256, s, generator=g, device=dev,
                          dtype=torch.int32) for s in shapes]
    return (ra, *res, *init, mb_w, mb_h)


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
        sys.exit("intra_bench: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    cases = {"1080p_b1": lambda: synthetic(MB_W, MB_H, 1, dev),
             "1080p_b4": lambda: synthetic(MB_W, MB_H, 4, dev),
             "1080p_random_intra_abi": lambda: random_abi(MB_W, MB_H, dev),
             "2160p_b1": lambda: synthetic(MB_W_4K, MB_H_4K, 1, dev),
             "2160p_b4": lambda: synthetic(MB_W_4K, MB_H_4K, 4, dev)}
    out = {"gpu": smi, "ms": {}, "md5": {}}
    for case, make in cases.items():
        inputs = make()
        outs = {k: fn(*inputs) for k, fn in KERNELS.items()}
        if md5(outs["K5"]) != md5(outs["K1"]):
            sys.exit(f"intra_bench: {case}: K5 differs from K1")
        if case == "1080p_b1":
            want = [p.to(torch.uint8) for p in intra_reconstruct(
                inputs[0], *inputs[1:4], *inputs[-2:])]
            if md5(want) != md5(outs["K1"]):
                sys.exit(f"intra_bench: {case}: K1 differs from the plain "
                         "version")
        out["md5"][case] = md5(outs["K1"])
        for k, fn in KERNELS.items():
            out["ms"][f"{k}_{case}"] = kernel_ms(lambda: fn(*inputs))
        del inputs, outs
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
