"""Times of the residual kernel K9 (residual_planes) and the reference
store kernel K11 (store_refs) on one GPU, with the MD5 of each output so
that two trees' outputs can be compared byte for byte.

    python tools/stage_bench.py [--out FILE.json]

K9 cases: the wire rounds (chip_smoke.wire_round's upload, as
chip_smoke.py's phase 3 makes them) of the smoke stream's picture 1 (B =
1) and of its pictures 1-4 as four lanes (B = 4), of conf_c5's picture 1
(3840x2160, B = 1) and of the uhd round (conf_c5's picture 1 in four
lanes); then random_residual_abi (every class, MB kind and qp) at
1920x1088 and 3840x2160, B = 1, lossy and with the lossless bypass.
K11 cases: random pictures into slot 1 of DPBs of 3 slots full of
random bytes, at 1920x1088 and 3840x2160, B = 1 and 4 (the MD5 is of the
whole DPBs).  Every output must equal its plain version (torch.equal),
or the script exits non-zero.  Each time is chip_smoke.kernel_ms:
launches queued behind a device sleep, the median of its rounds; each
bound is chip_smoke's (residual_need, store_need: bytes over 3.35 TB/s).
Prints one JSON line (with the card's nvidia-smi name and power limit)
and writes it to FILE if --out is given.  Needs a CUDA device and nvcc.
To compare two trees in one call, copy this script into a `git archive`
of the other tree and run both, in turns.
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

from arrow_h264_tpu_torch.models.pipeline import (  # noqa: E402
    dpb_alloc, upload_wire,
)
from arrow_h264_tpu_torch.ops.inter import store_refs_plain  # noqa: E402
from arrow_h264_tpu_torch.ops.kernels.residual import (  # noqa: E402
    residual_planes,
)
from arrow_h264_tpu_torch.ops.kernels.store_ref import (  # noqa: E402
    store_refs,
)
from arrow_h264_tpu_torch.ops.synthetic import (  # noqa: E402
    random_residual_abi,
)
from arrow_h264_tpu_torch.ops.transforms import (  # noqa: E402
    make_ws_consts, residual_planes as residual_plain,
)
from arrow_h264_tpu_torch.ops.wire import (  # noqa: E402
    merge_specs, pack_wire_raw,
)
from chip_smoke import (  # noqa: E402
    MB_H, MB_H_4K, MB_W, MB_W_4K, SEED, STREAM, bound, kernel_ms,
    residual_need, store_need, stream_abis,
)

SIZES = {"1080p": (MB_W, MB_H), "2160p": (MB_W_4K, MB_H_4K)}
CQP = (2, -3)


def k9_cases(dev):
    """(name, residual_planes arguments, bypass) of every K9 case."""
    ws = tuple(t.to(dev) for t in make_ws_consts([[16] * 16] * 6,
                                                 [[16] * 64] * 2))
    smoke, _ = stream_abis(STREAM.read_bytes(), dev)
    uhd, _ = stream_abis((STREAM.parent / "conf_c5.264").read_bytes(), dev)
    for name, abis, (mb_w, mb_h) in (
            ("K9_1080p_b1", smoke[1:2], SIZES["1080p"]),
            ("K9_1080p_b4", smoke[1:5], SIZES["1080p"]),
            ("K9_2160p_b1", uhd[1:2], SIZES["2160p"]),
            ("K9_2160p_b4", [uhd[1]] * 4, SIZES["2160p"])):
        packs = [pack_wire_raw(x, mb_w, mb_h) for x in abis]
        a = upload_wire(packs, merge_specs([sp for _, sp in packs]), mb_w,
                        mb_h, dev)
        yield name, (a, mb_w, mb_h, *ws), False
    for size, (mb_w, mb_h) in SIZES.items():
        a = {k: torch.from_numpy(v).to(dev) for k, v in
             random_residual_abi(mb_w, mb_h, 1, SEED + 60).items()}
        for bypass in (False, True):
            yield (f"K9_{size}_random_{'bypass' if bypass else 'lossy'}",
                   (a, mb_w, mb_h, *ws, CQP, bypass), bypass)


def k11_cases(dev):
    """(name, store_refs arguments) of every K11 case."""
    g = torch.Generator(device=dev).manual_seed(SEED + 61)
    for size, (mb_w, mb_h) in SIZES.items():
        H, W = 16 * mb_h, 16 * mb_w
        for B in (1, 4):
            dpbs = [t.view((B, 3) + t.shape[1:]) for t in
                    dpb_alloc(mb_w, mb_h, 3 * B, dev)]
            for t in dpbs:
                t.random_(0, 256, generator=g)
            pics = [torch.randint(0, 256, s, generator=g, device=dev,
                                  dtype=torch.uint8)
                    for s in ((B, H, W), (B, H // 2, W // 2),
                              (B, H // 2, W // 2))]
            yield f"K11_{size}_b{B}", (*dpbs, list(range(B)), [1] * B,
                                       *pics)


def md5(tensors) -> str:
    h = hashlib.md5()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def same(name: str, got, want) -> None:
    """Exit unless got equals want tensor by tensor (torch.equal)."""
    if len(got) != len(want) or not all(torch.equal(g, w)
                                        for g, w in zip(got, want)):
        sys.exit(f"stage_bench: {name} differs from the plain version")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write the JSON line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("stage_bench: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    out = {"gpu": smi, "ms": {}, "bound_ms": {}, "md5": {}}
    for name, a, bypass in k9_cases(dev):
        call = partial(residual_planes, *a)
        got = call()
        same(name, got, residual_plain(*a))
        out["md5"][name] = md5(got)
        out["ms"][name] = kernel_ms(call)
        out["bound_ms"][name] = bound(*residual_need(a[0], bypass, got))[0]
    for name, a in k11_cases(dev):
        want = [t.clone() for t in a[:2]]
        store_refs_plain(*want, *a[2:])
        call = partial(store_refs, *a)
        call()
        same(name, a[:2], want)
        out["md5"][name] = md5(a[:2])
        out["ms"][name] = kernel_ms(call)
        out["bound_ms"][name] = bound(*store_need(a[4:], a[:2], a[2]))[0]
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
