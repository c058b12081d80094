"""Times of the bm8 expansion K8 (unpack_bm8), the residual kernel K9
(residual_planes), the inter combine K10 (inter_combine) and the
reference store kernel K11 (store_refs) on one GPU, with the MD5 of each
output so that two trees' outputs can be compared byte for byte.

    python tools/stage_bench.py [--out FILE.json]

K8 cases: all bm8 classes of the wire rounds (chip_smoke.wire_round) of
the smoke stream's picture 1 (B = 1), its pictures 1-4 as four lanes
(B = 4), conf_c5's picture 1 (3840x2160, B = 1) and the uhd round
(conf_c5's picture 1 in four lanes), expanded as the tree expands them:
one call for the round where the tree has
ops/kernels/unpack_wire.py::unpack_bm8_round, else one unpack_bm8 call a
class (the MD5 is of the classes' outputs in wire order); and three
random 1920x1088 classes (l4, chroma AC, chroma DC sizes, a third of
the rows live, in four lanes) with their rows out of order, or with too
few values (positions past the last are clamped), one call as the tree
makes it (one ops/kernels/unpack_bm8.py::launch over its class_table,
else one unpack_bm8 call a class).  Of the four wire rounds it also
times the whole unpack_wire call (K12 and K8): kernel ms and the host's
ms a call (the wrappers' work, enqueued without waiting).
K9 cases: the wire rounds (chip_smoke.wire_round's upload, as
chip_smoke.py's phase 3 makes them) of the smoke stream's picture 1 (B =
1) and of its pictures 1-4 as four lanes (B = 4), of conf_c5's picture 1
(3840x2160, B = 1) and of the uhd round (conf_c5's picture 1 in four
lanes); then random_residual_abi (every class, MB kind and qp) at
1920x1088 and 3840x2160, B = 1, lossy and with the lossless bypass.
K10 cases: the smoke stream's first B picture (K3's and K4's lists
over the DPB its decode reads, its own residual) with its wire upload
(per-slice tables) and its dense upload (dense wp), and
random_weighted_abi with per-slice tables over random predictions and
residuals at 1920x1088 and 3840x2160, B = 1 and 4.
K11 cases: random pictures into slot 1 of DPBs of 3 slots full of
random bytes, at 1920x1088 and 3840x2160, B = 1 and 4 (the MD5 is of the
whole DPBs).  Every output must equal its plain version (torch.equal),
or the script exits non-zero.  Each time is chip_smoke.kernel_ms:
launches queued behind a device sleep, the median of its rounds; each
bound is chip_smoke's (bm8_need summed over a round's classes,
residual_need, combine_need, store_need: bytes over 3.35 TB/s).
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
import time
from functools import partial
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from arrow_h264_tpu_torch.models.pipeline import (  # noqa: E402
    dpb_alloc, upload_wire,
)
from arrow_h264_tpu_torch.ops.inter import (  # noqa: E402
    inter_init_plain, store_refs_plain,
)
from arrow_h264_tpu_torch.ops.kernels import unpack_bm8 as k8  # noqa: E402
from arrow_h264_tpu_torch.ops.kernels import unpack_wire as k12  # noqa: E402
from arrow_h264_tpu_torch.ops.kernels.inter_combine import (  # noqa: E402
    inter_combine,
)
from arrow_h264_tpu_torch.ops.kernels.mc import (  # noqa: E402
    mc_chroma, mc_luma,
)
from arrow_h264_tpu_torch.ops.kernels.residual import (  # noqa: E402
    residual_planes,
)
from arrow_h264_tpu_torch.ops.kernels.store_ref import (  # noqa: E402
    store_refs,
)
from arrow_h264_tpu_torch.ops.kernels.unpack_bm8 import (  # noqa: E402
    unpack_bm8,
)
from arrow_h264_tpu_torch.ops.synthetic import (  # noqa: E402
    random_residual_abi, random_weighted_abi,
)
from arrow_h264_tpu_torch.ops.transforms import (  # noqa: E402
    make_ws_consts, residual_planes as residual_plain,
)
from arrow_h264_tpu_torch.ops.wire import (  # noqa: E402
    _COEFF_FIELDS, _scatter_bm8, merge_specs, pack_wire_raw, unpack_wire,
)
from chip_smoke import (  # noqa: E402
    MB_H, MB_H_4K, MB_W, MB_W_4K, SEED, STREAM, bm8_need, bound,
    combine_need, kernel_ms, residual_need, store_need, stream_abis,
    stream_mc_inputs, wire_round,
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


def k8_wire_cases(dev):
    """(name, wire buffer, spec, mb_w, mb_h, classes as wire_round gives
    them) of every K8 wire round."""
    smoke, _ = stream_abis(STREAM.read_bytes(), dev)
    uhd, _ = stream_abis((STREAM.parent / "conf_c5.264").read_bytes(), dev)
    for name, abis, (mb_w, mb_h) in (
            ("K8_1080p_b1", smoke[1:2], SIZES["1080p"]),
            ("K8_1080p_b4", smoke[1:5], SIZES["1080p"]),
            ("K8_2160p_b1", uhd[1:2], SIZES["2160p"]),
            ("K8_2160p_b4", [uhd[1]] * 4, SIZES["2160p"])):
        buf, spec, classes = wire_round(abis, mb_w, mb_h, dev)
        yield name, buf, spec, mb_w, mb_h, classes


def k8_random_cases(dev):
    """(name, [(idx, bm, vals, grid, w)] views of one [4, total] byte
    buffer, lanes a row stride apart) of the random K8 cases."""
    g = torch.Generator().manual_seed(SEED + 63)
    B, n = 4, MB_W * MB_H
    for what in ("unsorted", "clamped"):
        parts, at = [], 0
        for _, _, cpm, w in (c for c in _COEFF_FIELDS
                             if c[0] in ("l4", "ca", "cdc")):
            grid, bmw = n * cpm, (w + 15) // 16
            br = grid // 3
            idx = torch.stack([torch.randperm(grid, generator=g)[:br]
                               for _ in range(B)]).int()
            if what != "unsorted":
                idx = idx.sort(1).values
            bm = torch.randint(0, 1 << 16, (B, br, bmw), generator=g,
                               dtype=torch.int32).to(torch.int16)
            need = int(((bm.int() & 0xFFFF)[..., None] >> torch.arange(16)
                        & 1).reshape(B, br, -1)[..., :w].sum((1, 2)).max())
            bv = need // 2 if what == "clamped" else need
            vals = torch.randint(-128, 128, (B, bv), generator=g,
                                 dtype=torch.int8)
            for t in (idx, bm, vals):
                raw = t.reshape(B, -1).view(torch.uint8)
                parts.append((at, raw, t.dtype, t.shape))
                at += -(-raw.shape[1] // 8) * 8
            parts.append((grid, w))
        buf = torch.zeros((B, at + 8), dtype=torch.uint8)
        classes, sec = [], []
        for p in parts:
            if len(p) == 2:
                classes.append((*sec, *p))
                sec = []
                continue
            off, raw, dtype, shape = p
            buf[:, off:off + raw.shape[1]] = raw
            sec.append((off, raw.shape[1], dtype, shape))
        buf = buf.to(dev)
        views = [tuple(buf[:, off:off + nb].view(dt).view(shape)
                       for off, nb, dt, shape in secs) + (grid, w)
                 for *secs, grid, w in classes]
        yield f"K8_1080p_b4_random_{what}", buf, views


def k8_classes_call(buf, views):
    """All classes `views` (of buf) in one call as the tree makes it."""
    if not hasattr(k8, "class_table"):
        return lambda: [unpack_bm8(*v) for v in views]
    B, words, entries = buf.shape[0], 0, []
    for idx, bm, vals, grid, w in views:
        entries.append((idx.data_ptr(), bm.data_ptr(), vals.data_ptr(),
                        idx.stride(0) * 4, bm.stride(0) * 2, vals.stride(0),
                        idx.shape[1], vals.shape[1], grid, w, words))
        words += B * grid * w
    t = k8.class_table(entries, B)
    out = torch.empty(words, dtype=torch.int32, device=buf.device)

    def call():
        k8.launch(0, out, t, B, buf.device)
        at, res = 0, []
        for _, _, _, grid, w in views:
            res.append(out[at:at + B * grid * w].view(B, grid, w))
            at += B * grid * w
        return res
    return call


def k8_wire_call(buf, spec, mb_w, mb_h, classes):
    """A round's bm8 classes as the tree expands them -> a call giving
    their outputs in wire order."""
    if hasattr(k12, "unpack_bm8_round"):
        key = {f: k for f, k, *_ in _COEFF_FIELDS}

        def call():
            got = k12.unpack_bm8_round(buf, mb_w, mb_h, spec)
            return [got[key[f]].view(buf.shape[0], grid, w)
                    for f, _, _, _, grid, w in classes]
        return call
    return lambda: [unpack_bm8(*c[1:]) for c in classes]


def host_ms(call, reps: int = 50) -> float:
    """The host's ms a call: `reps` calls enqueued back to back, without
    waiting for the device."""
    call()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        call()
    ms = 1e3 * (time.perf_counter() - t) / reps
    torch.cuda.synchronize()
    return ms


def k10_cases(dev):
    """(name, inter_combine arguments) of every K10 case."""
    ws = tuple(t.to(dev) for t in make_ws_consts([[16] * 16] * 6,
                                                 [[16] * 64] * 2))
    dpb_y, dpb_c, *_, (a, dense) = stream_mc_inputs(STREAM.read_bytes(),
                                                    dev)["B"]
    zero = torch.zeros(dpb_c.shape[:2], dtype=torch.int32, device=dev)
    pred = (mc_luma(dpb_y, a["mv"], a["refslot"], MB_W, MB_H),
            mc_chroma(dpb_c, a["mv"], a["refslot"], zero, MB_W, MB_H))
    for name, up in (("K10_1080p_b1_smoke_B", a),
                     ("K10_1080p_b1_smoke_B_dense", dense)):
        yield name, (up, *pred, *residual_planes(up, MB_W, MB_H, *ws),
                     MB_W, MB_H)
    del dpb_y, dpb_c, a, dense, pred
    g = torch.Generator(device=dev).manual_seed(SEED + 61)
    for size, (mb_w, mb_h) in SIZES.items():
        H, W = 16 * mb_h, 16 * mb_w
        for B in (1, 4):
            a = {k: torch.from_numpy(v).to(dev) for k, v in
                 random_weighted_abi(mb_w, mb_h, B, SEED + 62).items()}
            pred = [torch.randint(0, 256, s, generator=g, device=dev,
                                  dtype=torch.uint8)
                    for s in ((B, 2, H, W), (B, 2, 2, H // 2, W // 2))]
            res = [torch.randint(-300, 300, s, generator=g, device=dev,
                                 dtype=torch.int32)
                   for s in ((B, H, W), (B, H // 2, W // 2),
                             (B, H // 2, W // 2))]
            yield f"K10_{size}_b{B}_random", (a, *pred, *res, mb_w, mb_h)


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
    out = {"gpu": smi, "ms": {}, "bound_ms": {}, "md5": {}, "host_ms": {},
           "unpack_wire_ms": {}}
    for name, buf, spec, mb_w, mb_h, classes in k8_wire_cases(dev):
        if not classes:
            sys.exit(f"stage_bench: {name} ships no class as bm8")
        call = k8_wire_call(buf, spec, mb_w, mb_h, classes)
        got = call()
        same(name, got, [_scatter_bm8(*c[1:]) for c in classes])
        out["md5"][name] = md5(got)
        out["ms"][name] = kernel_ms(call)
        out["bound_ms"][name] = bound(*[sum(x) for x in zip(*(
            bm8_need(*c[1:4], o) for c, o in zip(classes, got)))])[0]
        whole = partial(unpack_wire, buf, mb_w, mb_h, spec)
        out["unpack_wire_ms"][name] = kernel_ms(whole)
        out["host_ms"][name] = host_ms(whole)
    for name, buf, views in k8_random_cases(dev):
        call = k8_classes_call(buf, views)
        got = call()
        same(name, got, [_scatter_bm8(*(t.contiguous() for t in v[:3]),
                                      *v[3:]) for v in views])
        out["md5"][name] = md5(got)
        out["ms"][name] = kernel_ms(call)
        out["bound_ms"][name] = bound(*[sum(x) for x in zip(*(
            bm8_need(*v[:3], o) for v, o in zip(views, got)))])[0]
    for name, a in k10_cases(dev):
        call = partial(inter_combine, *a)
        got = call()
        same(name, got, inter_init_plain(*a))
        out["md5"][name] = md5(got)
        out["ms"][name] = kernel_ms(call)
        out["bound_ms"][name] = bound(*combine_need(a[0], a[1], a[2], a[3:6],
                                                    got))[0]
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
