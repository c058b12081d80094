"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero):
  1. device   require CUDA; print the card (nvidia-smi) and CUDA version
  2. build    compile arrow_h264_tpu_torch/csrc/*.cu with nvcc (sm_90a)
  3. kernels  each kernel against its plain PyTorch version on the card at
              1080p (mb 120 x 68), exact equality, with CUDA-event times
  4. decode   arrow_h264_tpu_torch.api.Decoder(device="cuda") decodes
              tests/data/smoke_1080p_high.264; every frame's MD5 must equal
              the committed libavcodec golden, and every kernel must have
              launched in that decode
Then one JSON line of per-kernel results, the nvidia-smi line, and the
last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
STREAM = REPO / "tests" / "data" / "smoke_1080p_high.264"
MB_W, MB_H = 120, 68          # 1920x1088 coded
SEED = 0
KERNEL_REPS = 20


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up call, from CUDA
    events (for host-bound plain versions this is their wall time)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got, want) -> int:
    """Exact equality of two tensors or tuples of tensors; returns the max
    absolute error (0) or exits."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape:
            sys.exit(f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        err = max(err, int((g.long() - w.long()).abs().max().item()))
    if err:
        sys.exit(f"{name}: kernel differs from its plain version "
                 f"(max abs err {err})")
    return err


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script runs only on a GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    log("device", f"{torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.device_count()} device(s)")

    from arrow_h264_tpu_torch.api import Decoder
    from arrow_h264_tpu_torch.models.pipeline import dpb_alloc, store_ref_fn
    from arrow_h264_tpu_torch.ops import kernels
    from arrow_h264_tpu_torch.ops.deblock import (
        deblock_filter_planes, deblock_tables,
    )
    from arrow_h264_tpu_torch.ops.intra import intra_reconstruct
    from arrow_h264_tpu_torch.ops.inter import mc_chroma_plain, mc_luma_plain
    from arrow_h264_tpu_torch.ops.kernels import build
    from arrow_h264_tpu_torch.ops.kernels.deblock_phase import deblock_phase
    from arrow_h264_tpu_torch.ops.kernels.intra_phase import intra_phase
    from arrow_h264_tpu_torch.ops.kernels.mc import mc_chroma, mc_luma
    from arrow_h264_tpu_torch.ops.synthetic import synthetic_batch
    from arrow_h264_tpu_torch.ops.transforms import (
        make_ws_consts, residual_planes,
    )

    # ---- build
    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    log("build", f"{lib.relative_to(REPO)} in "
        f"{time.perf_counter() - t0:.3f} s (nvcc {build.build_seconds} s)")

    # ---- kernels vs plain versions at 1080p
    H, W = MB_H * 16, MB_W * 16
    ws4, ws8 = (t.to(dev) for t in make_ws_consts([[16] * 16] * 6,
                                                  [[16] * 64] * 2))
    results = {}

    def record(key, name, src, replaces, err, ms, plain_ms, note):
        log("kernels", f"{name} {note}: equal, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
        results.setdefault(key, dict(
            name=name, route="cuda", source=src, replaces=replaces,
            max_abs_err=err, ms=ms, plain_ms=plain_ms))

    # K1 + K2 on synthetic I (all intra) and P (inter MVs: bS 0..2) ABIs
    for note, inter in (("synthetic_abi", False), ("synthetic_abi_p", True)):
        _, a = synthetic_batch(MB_W, MB_H, SEED, dev, inter=inter,
                               **({"bi_frac": 0.3} if inter else {}))
        res = residual_planes(a, MB_W, MB_H, ws4, ws8)
        if note == "synthetic_abi":
            planes = intra_phase(a, *res, None, None, None, MB_W, MB_H)
            torch.cuda.synchronize()
            want = intra_reconstruct(a, *res, MB_W, MB_H)
            err = compare("intra_phase", planes,
                          tuple(p.to(torch.uint8) for p in want))
            ms = cuda_ms(lambda: intra_phase(a, *res, None, None, None,
                                             MB_W, MB_H), KERNEL_REPS)
            plain = cuda_ms(lambda: intra_reconstruct(a, *res, MB_W, MB_H), 1)
            record("intra_phase", "intra_phase (K1)",
                   "arrow_h264_tpu_torch/csrc/intra_phase.cu",
                   "arrow_h264_tpu/ops/pallas/intra_phase.py:694",
                   err, ms, plain, note)
        else:                        # mid-grey planes with texture
            g = torch.Generator(device=dev).manual_seed(SEED)
            planes = tuple(torch.randint(96, 160, s, generator=g, device=dev,
                                         dtype=torch.uint8)
                           for s in ((1, H, W), (1, H // 2, W // 2),
                                     (1, H // 2, W // 2)))
        tables = deblock_tables(a, MB_W, MB_H)
        got = deblock_phase(*(p.clone() for p in planes), tables, MB_W, MB_H)
        torch.cuda.synchronize()
        want = deblock_filter_planes(*planes, tables, MB_W, MB_H)
        err = compare("deblock_phase", got,
                      tuple(p.to(torch.uint8) for p in want))
        work = tuple(p.clone() for p in planes)
        ms = cuda_ms(lambda: deblock_phase(*work, tables, MB_W, MB_H),
                     KERNEL_REPS)
        plain = cuda_ms(lambda: deblock_filter_planes(*planes, tables,
                                                      MB_W, MB_H), 1)
        record("deblock_phase", "deblock_phase (K2)",
               "arrow_h264_tpu_torch/csrc/deblock_phase.cu",
               "arrow_h264_tpu/ops/pallas/deblock_phase.py:395",
               err, ms, plain, note)

    # K3 + K4 on a P/B ABI over 4 random reference pictures, then with 5%
    # wild MVs (+-512 quarter samples)
    n_slots = 4
    dpb_y, dpb_c = dpb_alloc(MB_W, MB_H, n_slots, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    for s in range(n_slots):
        store_ref_fn(dpb_y, dpb_c, s, *(
            torch.randint(0, 256, shp, generator=g, device=dev,
                          dtype=torch.uint8)
            for shp in ((H, W), (H // 2, W // 2), (H // 2, W // 2))))
    dpb_y, dpb_c = dpb_y[None], dpb_c[None]
    abi_h, _ = synthetic_batch(MB_W, MB_H, SEED + 2, dev, inter=True,
                               n_slots=n_slots, bi_frac=0.3)
    rng = np.random.default_rng(SEED + 3)
    wild = rng.random((MB_W * MB_H, 4, 4)) < 0.05
    wmv = rng.integers(-512, 513, abi_h["mv"].shape).astype(np.int32)
    for note, mv_h in (("synthetic_abi_p", abi_h["mv"]),
                       ("wild mv", np.where(wild[..., None, None], wmv,
                                            abi_h["mv"]))):
        mv = torch.from_numpy(np.ascontiguousarray(mv_h)).to(dev)[None]
        rs = torch.from_numpy(abi_h["refslot"]).to(dev)[None]
        for key, kern, plain_fn, dpb, src_name in (
                ("mc_luma", mc_luma, mc_luma_plain, dpb_y, "K3"),
                ("mc_chroma", mc_chroma, mc_chroma_plain, dpb_c, "K4")):
            got = kern(dpb, mv, rs, MB_W, MB_H)
            torch.cuda.synchronize()
            err = compare(key, got, plain_fn(dpb, mv, rs, MB_W, MB_H))
            ms = cuda_ms(lambda: kern(dpb, mv, rs, MB_W, MB_H), KERNEL_REPS)
            plain = cuda_ms(lambda: plain_fn(dpb, mv, rs, MB_W, MB_H),
                            KERNEL_REPS)
            record(key, f"{key} ({src_name})",
                   "arrow_h264_tpu_torch/csrc/mc.cu",
                   "arrow_h264_tpu/ops/pallas/mc_kernel.py:"
                   + ("460" if key == "mc_luma" else "505"),
                   err, ms, plain, note)

    # ---- the main path: decode the committed 1080p High stream
    golden = json.loads(STREAM.with_suffix(".json").read_text())
    data = STREAM.read_bytes()

    def decode():
        dec = Decoder(device="cuda")
        t = time.perf_counter()
        md5 = [hashlib.md5(f.planar()).hexdigest()
               for f in dec.decode_annexb(data)]
        torch.cuda.synchronize()
        return dec, md5, time.perf_counter() - t

    dec, md5, cold_s = decode()                 # warm-up: first-call costs
    kernels.reset_launches()
    dec, md5, wall_s = decode()
    launches = dict(kernels.LAUNCHES)
    if dec.entropy != "cpp":
        sys.exit(f"decode: host entropy is {dec.entropy!r}, not the C++ "
                 "library")
    if md5 != golden["md5"]:
        bad = [i for i, (a, b) in enumerate(zip(md5, golden["md5"]))
               if a != b]
        sys.exit(f"decode: {len(md5)} frames, golden {len(golden['md5'])}; "
                 f"MD5 mismatch at frames {bad}")
    if not all(launches.values()):
        sys.exit(f"decode: a kernel never launched: {launches}")
    log("decode", f"{len(md5)} frames {golden['width']}x{golden['height']} "
        f"MD5 == libavcodec golden; {wall_s:.3f} s wall, "
        f"{len(md5) / wall_s:.3f} fps (first pass {cold_s:.3f} s) on "
        f"{smi}; launches {launches}; stats {dec.stats.as_dict()}")

    if "jax" in sys.modules:
        sys.exit("the port imported jax")
    for key, r in results.items():
        r["launches"] = launches[key]
    print(json.dumps({"kernels": list(results.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
