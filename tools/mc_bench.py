"""Times of the MC kernels K3 (mc_luma) and K4 (mc_chroma) on one GPU, on
input families that separate what each costs, with the MD5 of each output
so that two trees' outputs can be compared byte for byte.

    python tools/mc_bench.py [--out FILE.json] [--family NAME ...]

Families (motion `[B, n, 4, 4, 2, 2]` and slots `[B, n, 4, 4, 2]` over
MC_SLOTS random reference pictures a stream; `motion` builds each from
the seed):
  synthetic    chip_smoke.py's synthetic_abi_p motion: an MV from a
               palette of 24 and a slot for every 4x4 cell, list 1 in
               30 % of the cells, 5 % intra MBs
  mb           one MV and slot a list for each MB (16x16 partitions)
  partitions   each MB split 16x8, 8x16 or 8x8, one MV and slot a part
  one          one MV and slot for all cells of a list, at one
               quarter-sample position (synthetic's list use)
  integer      synthetic with integer MVs: one plane a read
  two_planes   synthetic at the 12 positions that average two planes
  wild         synthetic's slots, MVs anywhere in +-2048 quarter samples
  smoke_P/B    the first P and B picture of tests/data/smoke_1080p_high.264
               with the DPB its decode reads (chip_smoke.stream_mc_inputs;
               1080p only, at B = 8 the same picture in every lane)
Each at 1920x1088, B = 1 and 8, and 3840x2160, B = 1.  K4 gets zero
cross-parity offsets, as frames pass.  Each time is chip_smoke.kernel_ms
(launches queued behind a device sleep, the median of its rounds) beside
chip_smoke.mc_need's byte bound; each output must equal the plain
version's (ops/inter.py), or it exits non-zero.  Prints one JSON line
(with the card's nvidia-smi name and power limit) and writes it to FILE
if --out is given.  Needs a CUDA device and nvcc.  The script makes its
inputs itself, so a copy of it runs unchanged in a `git archive` of
another tree: run both trees in one call, in turns.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from arrow_h264_tpu_torch.ops.inter import (  # noqa: E402
    PAD, PADC, mc_chroma_plain, mc_luma_plain,
)
from arrow_h264_tpu_torch.ops.kernels.mc import (  # noqa: E402
    mc_chroma, mc_luma,
)
from chip_smoke import (  # noqa: E402
    B8, MB_H, MB_H_4K, MB_W, MB_W_4K, SEED, STREAM, bound, kernel_ms,
    mc_need, stream_mc_inputs,
)

MC_SLOTS = 4
SIZES = (("1080p", MB_W, MB_H, 1), ("1080p", MB_W, MB_H, B8),
         ("2160p", MB_W_4K, MB_H_4K, 1))
FAMILIES = ("synthetic", "mb", "partitions", "one", "integer", "two_planes",
            "wild", "smoke_P", "smoke_B")
# quarter-sample positions (yFrac * 4 + xFrac) whose prediction averages
# two reads (ops/inter.py LUMA_TAB); G, b, h and j read one
TWO_READS = (1, 3, 4, 5, 6, 7, 9, 11, 12, 13, 14, 15)
# MB splits: (cells of each part as a [4, 4] label map)
SPLITS = {
    "16x16": np.zeros((4, 4), np.int64),
    "16x8": np.repeat(np.arange(2), 8).reshape(4, 4),
    "8x16": np.tile(np.repeat(np.arange(2), 2), 4).reshape(4, 4),
    "8x8": np.array([[0, 0, 1, 1], [0, 0, 1, 1], [2, 2, 3, 3], [2, 2, 3, 3]]),
    "4x4": np.arange(16).reshape(4, 4),
}


def synthetic_motion(mb_w: int, mb_h: int, seed: int, n_slots: int = MC_SLOTS,
                     bi_frac: float = 0.3, intra_frac: float = 0.05,
                     n_mv: int = 24) -> tuple[np.ndarray, np.ndarray]:
    """(mv [n, 4, 4, 2, 2], refslot [n, 4, 4, 2]) int32 of
    ops/synthetic.py::synthetic_abi_p(mb_w, mb_h, seed, n_slots=n_slots,
    bi_frac=bi_frac): the same draws, without the rest of the ABI."""
    rng = np.random.default_rng(seed + 1000)
    n = mb_w * mb_h
    inter = rng.random(n) >= intra_frac
    palette = rng.integers(-64, 65, (n_mv, 2)).astype(np.int32)
    mv = np.zeros((n, 4, 4, 2, 2), np.int32)
    rs = np.full((n, 4, 4, 2), -1, np.int32)
    mv[..., 0, :] = palette[rng.integers(0, n_mv, (n, 4, 4))]
    slot = rng.integers(0, n_slots, (n, 4, 4)).astype(np.int32)
    im = inter[:, None, None]
    rs[..., 0] = np.where(im, slot, -1)
    if bi_frac > 0:
        bi = (rng.random((n, 4, 4)) < bi_frac) & im
        mv[..., 1, :] = palette[rng.integers(0, n_mv, (n, 4, 4))]
        rs[..., 1] = np.where(bi, rng.integers(0, n_slots, (n, 4, 4)), -1)
    return mv, rs


def partitioned_motion(mb_w: int, mb_h: int, seed: int, splits,
                       n_slots: int = MC_SLOTS, span: int = 64,
                       bi_frac: float = 0.3) -> tuple[np.ndarray, np.ndarray]:
    """Each MB split one of `splits` (names of SPLITS) at random, each
    part with one MV (+-span quarter samples) and one slot a list; list 1
    used in bi_frac of the MBs, 5 % of the MBs intra."""
    rng = np.random.default_rng(seed)
    n = mb_w * mb_h
    labels = np.stack([SPLITS[s] for s in splits])[
        rng.integers(0, len(splits), n)]                      # [n, 4, 4]
    part_mv = rng.integers(-span, span + 1, (n, 16, 2, 2))
    part_slot = rng.integers(0, n_slots, (n, 16, 2))
    idx = np.arange(n)[:, None, None]
    mv = part_mv[idx, labels].astype(np.int32)                # [n,4,4,2,2]
    rs = part_slot[idx, labels].astype(np.int32)              # [n,4,4,2]
    inter = rng.random(n) >= 0.05
    bi = (rng.random(n) < bi_frac) & inter
    rs[..., 0] = np.where(inter[:, None, None], rs[..., 0], -1)
    rs[..., 1] = np.where(bi[:, None, None], rs[..., 1], -1)
    return mv, rs


def motion(family: str, mb_w: int, mb_h: int, B: int,
           seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(mv [B, n, 4, 4, 2, 2], refslot [B, n, 4, 4, 2]) int32 of one of
    FAMILIES but the smoke pictures, stream b drawn from seed + b."""
    mvs, rss = [], []
    for b in range(B):
        s = seed + b
        if family == "mb":
            mv, rs = partitioned_motion(mb_w, mb_h, s, ("16x16",))
        elif family == "partitions":
            mv, rs = partitioned_motion(mb_w, mb_h, s, ("16x8", "8x16",
                                                        "8x8"))
        else:
            mv, rs = synthetic_motion(mb_w, mb_h, s)
            rng = np.random.default_rng(s + 7)
            if family == "one":
                mv = np.broadcast_to(np.array([5, 3], np.int32), mv.shape)
                rs = np.where(rs >= 0, np.arange(2, dtype=np.int32), -1)
            elif family == "integer":
                mv = mv & ~3
            elif family == "two_planes":
                pos = rng.choice(TWO_READS, mv.shape[:-1])
                mv = (mv & ~3) | np.stack([pos & 3, pos >> 2], -1)
            elif family == "wild":
                mv = rng.integers(-2048, 2049, mv.shape)
            elif family != "synthetic":
                raise ValueError(f"unknown MC family {family!r}")
        mvs.append(np.ascontiguousarray(mv, np.int32))
        rss.append(np.ascontiguousarray(rs, np.int32))
    return np.stack(mvs), np.stack(rss)


def random_dpbs(mb_w: int, mb_h: int, B: int, seed: int, dev):
    """Luma [B, MC_SLOTS, 4, Hp, Wp] and chroma [B, MC_SLOTS, 2, Hcp,
    Wcp] uint8 DPBs of random bytes, padding included."""
    H, W = mb_h * 16, mb_w * 16
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randint(0, 256, shape, generator=g, device=dev,
                               dtype=torch.uint8)
                 for shape in ((B, MC_SLOTS, 4, H + 2 * PAD, W + 2 * PAD),
                               (B, MC_SLOTS, 2, H // 2 + 2 * PADC,
                                W // 2 + 2 * PADC)))


def md5(t) -> str:
    return hashlib.md5(t.cpu().numpy().tobytes()).hexdigest()


def run_case(case: str, dpb_y, dpb_c, mv, rs, mb_w: int, mb_h: int,
             out: dict) -> None:
    """K3 and K4 on one input: equal to the plain versions, timed, MD5."""
    cvoff = torch.zeros(dpb_c.shape[:2], dtype=torch.int32,
                        device=dpb_c.device)
    for kid, kern, plain, args in (
            ("K3", mc_luma, mc_luma_plain, (dpb_y, mv, rs)),
            ("K4", mc_chroma, mc_chroma_plain, (dpb_c, mv, rs, cvoff))):
        got = kern(*args, mb_w, mb_h)
        if not torch.equal(got, plain(*args, mb_w, mb_h)):
            sys.exit(f"mc_bench: {kid} {case} differs from the plain version")
        key = f"{kid}_{case}"
        out["md5"][key] = md5(got)
        out["ms"][key] = kernel_ms(lambda: kern(*args, mb_w, mb_h))
        out["bound_ms"][key] = bound(*mc_need(got, *args[1:]))[0]
        print(f"[mc_bench] {key}: {out['ms'][key]:.4f} ms, bound "
              f"{out['bound_ms'][key]:.4f} ms", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write the JSON line here")
    ap.add_argument("--family", nargs="*", choices=FAMILIES,
                    default=list(FAMILIES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("mc_bench: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    out = {"gpu": smi, "ms": {}, "bound_ms": {}, "md5": {}}
    smoke = {}
    if {"smoke_P", "smoke_B"} & set(args.family):
        smoke = stream_mc_inputs(STREAM.read_bytes(), dev)
    for size, mb_w, mb_h, B in SIZES:
        dpbs = random_dpbs(mb_w, mb_h, B, SEED + B, dev)
        for fam in args.family:
            case = f"{fam}_{size}_b{B}"
            if fam.startswith("smoke_"):
                if size != "1080p":
                    continue
                *sdpbs, mv, rs, _ = smoke[fam[-1]]
                rep = lambda t: t.repeat(B, *([1] * (t.dim() - 1)))
                run_case(case, *map(rep, (*sdpbs, mv, rs)), mb_w, mb_h, out)
                continue
            mv, rs = (torch.from_numpy(a).to(dev) for a in motion(
                fam, mb_w, mb_h, B, SEED + 30))
            run_case(case, *dpbs, mv, rs, mb_w, mb_h, out)
        del dpbs
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
