"""Where the time of the persistent kernels goes, on one GPU: K1
(intra_phase) and K2 (deblock_phase) on the knight-move wavefront, K5
(intra_raster) and K6 (deblock_raster) on the row pipeline.

    python tools/wavefront_probe.py [--size 1080p|2160p] [--out FILE.json]

Builds variants of csrc/intra_phase.cu, csrc/deblock_phase.cu,
csrc/intra_raster.cu and csrc/deblock_raster.cu from the sources in the
checkout (text edits of copies, each variant one library under
arrow_h264_tpu_torch/_build/probe/) and times each, through the port's
wrappers, on chip_smoke.py's synthetic all-intra frame (half I4x4, half
I16x16 MBs) at 1920x1088 (--size 1080p, the default) or 3840x2160
(--size 2160p), at B = 1 and on four such frames (B = 4), and at B = 1
on the same frame with every MB made I4x4 or I16x16 (K2 and K6 on the
exact output of K1 as built, in every variant):
  as_built      the sources as they are
  acquire_poll  the flags and row counters polled with acquire loads
                instead of relaxed loads plus one acquire fence
  no_waits      no waits: every MB (K1/K2) or every row (K5/K6) at once
                (output not exact), so the time is the throughput floor
                of the bodies
  no_fence      the waits without their acquire fence (output not exact):
                what the fence, which invalidates the SM's L1, costs
  relaxed_pub   flags and counters set with relaxed stores instead of
                release stores (output not exact)
  no_bodies     the waits, flags and counters without the MB bodies (and
                without their staging: K1/K5's of an MB's residual and
                modes, K2/K6's of its samples and table words): the
                hand-off chain alone
  no_chroma     K1/K5 and K2/K6 without the chroma body: the luma chain
                alone (the chroma parts still stage their inputs)
  no_luma       K1/K5 and K2/K6 without the luma body: the chroma chain
                alone (the luma parts still stage theirs)
  one_per_sm    the grid cut to one block per SM
For each variant it also counts the L1-invalidating CCTL instructions
in the compiled code (cuobjdump -sass).  Prints a table, and writes the
numbers as JSON to FILE if --out is given.  Needs a CUDA device and
nvcc.  tests/test_torch_wavefront.py checks on the CPU that every edit
still applies to the sources.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from arrow_h264_tpu_torch.ops.deblock import deblock_tables  # noqa: E402
from arrow_h264_tpu_torch.ops.kernels import build  # noqa: E402
from arrow_h264_tpu_torch.ops.kernels.deblock_phase import (  # noqa: E402
    deblock_phase,
)
from arrow_h264_tpu_torch.ops.kernels.deblock_raster import (  # noqa: E402
    deblock_raster,
)
from arrow_h264_tpu_torch.ops.kernels.intra_phase import (  # noqa: E402
    intra_phase,
)
from arrow_h264_tpu_torch.ops.kernels.intra_raster import (  # noqa: E402
    intra_raster,
)
from arrow_h264_tpu_torch.ops.synthetic import synthetic_batch  # noqa: E402
from arrow_h264_tpu_torch.ops.transforms import (  # noqa: E402
    make_ws_consts, residual_planes,
)
from chip_smoke import (  # noqa: E402
    MB_H, MB_H_4K, MB_W, MB_W_4K, SEED, cuda_ms,
)

REPS = 20
SOURCES = ("intra_phase.cu", "deblock_phase.cu", "intra_raster.cu",
           "deblock_raster.cu")
# (intra kernel id, wrapper, deblock kernel id, wrapper) of each schedule
PAIRS = ((1, intra_phase, 2, deblock_phase),
         (5, intra_raster, 6, deblock_raster))
INTRA = ("intra_phase.cu", "intra_raster.cu")
LUMA = "intra::intra_mb_luma(a, sm, buf, b, mx, my, kind, t);"
CHROMA = "intra::intra_mb_chroma(a, sm, buf, b, mx, my, kind, t);"
# the first statements of intra_mb.cuh's stage and describe, and of
# deblock_mb.cuh's stage and mb_body
STAGE = "  Stage& st = sm.stage[buf];\n  const long mbo"
DESCRIBE = "  if (t < 32 || t >= 64) return;\n  copy_wait();"
DB_STAGE = "  const long m = (long)b * a.mb_w * a.mb_h + my * a.mb_w + mx;\n"
DB_BODY = "  gather(a, s, b, mx, my, part, carried, lane);\n"
# variant -> [(file, text, replacement)]; each text must occur in the file
VARIANTS = {
    "as_built": [],
    "acquire_poll": [("wavefront.cuh", "f.load(cuda::memory_order_relaxed)",
                      "f.load(cuda::memory_order_acquire)")],
    "no_waits": [("wavefront.cuh", "  Flag f(*counter);\n",
                  "  return;\n  Flag f(*counter);\n")],
    "no_fence": [("wavefront.cuh",
                  "  cuda::atomic_thread_fence(cuda::memory_order_acquire,\n"
                  "                            cuda::thread_scope_device);\n",
                  "")],
    "relaxed_pub": [("wavefront.cuh",
                     "store(value, cuda::memory_order_release)",
                     "store(value, cuda::memory_order_relaxed)")],
    "no_bodies": [("intra_mb.cuh", STAGE, "  return;\n" + STAGE),
                  ("intra_mb.cuh", DESCRIBE, "  return;\n" + DESCRIBE)]
    + [(f, LUMA, ";") for f in INTRA]
    + [(f, CHROMA, ";") for f in INTRA]
    + [("deblock_mb.cuh", DB_STAGE, "  return;\n" + DB_STAGE),
       ("deblock_mb.cuh", DB_BODY, "  return;\n" + DB_BODY)],
    "no_chroma": [(f, CHROMA, ";") for f in INTRA]
    + [("deblock_mb.cuh", DB_BODY, "  if (part == 1) return;\n" + DB_BODY)],
    "no_luma": [(f, LUMA, ";") for f in INTRA]
    + [("deblock_mb.cuh", DB_BODY, "  if (part == 0) return;\n" + DB_BODY)],
    "one_per_sm": [("wavefront.cuh", "const long g = (long)sms * per_sm;",
                    "const long g = sms;")],
}
KINDS = {"i4x4": 0, "i16": 2}           # frames of one MB kind
SIZES = {"1080p": (MB_W, MB_H), "2160p": (MB_W_4K, MB_H_4K)}


def variant_sources(name: str, d: Path) -> list[Path]:
    """Copy the wavefront kernels' sources into `d`, apply the edits of
    variant `name`, and return the translation units."""
    d.mkdir(parents=True, exist_ok=True)
    for src in list(build.CSRC.glob("*.cuh")) + [build.CSRC / s
                                                   for s in SOURCES]:
        shutil.copy(src, d / src.name)
    for fname, old, new in VARIANTS[name]:
        text = (d / fname).read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} not in {fname}")
        (d / fname).write_text(text.replace(old, new))
    return [d / s for s in SOURCES]


def build_variant(name: str) -> Path:
    d = build.BUILD_DIR / "probe" / name
    shutil.rmtree(d, ignore_errors=True)
    lib = d / f"lib{name}.so"
    build.compile_library(variant_sources(name, d), lib)
    return lib


def cctl_count(lib: Path) -> int:
    sass = subprocess.run([str(Path(build.nvcc()).parent / "cuobjdump"),
                           "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    return sum("CCTL" in line for line in sass.splitlines())


def inputs(mb_w: int, mb_h: int, B: int, dev, kind: int | None = None):
    ws4, ws8 = (t.to(dev) for t in make_ws_consts([[16] * 16] * 6,
                                                  [[16] * 64] * 2))
    batch = [synthetic_batch(mb_w, mb_h, SEED + i, dev)[1] for i in range(B)]
    a = {k: torch.cat([x[k] for x in batch]) for k in batch[0]}
    if kind is not None:
        a["kind"] = torch.full_like(a["kind"], kind)
    return a, residual_planes(a, mb_w, mb_h, ws4, ws8), \
        deblock_tables(a, mb_w, mb_h)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", choices=SIZES, default="1080p")
    ap.add_argument("--out", help="write the numbers as JSON here")
    args = ap.parse_args()
    mb_w, mb_h = SIZES[args.size]
    if not torch.cuda.is_available():
        sys.exit("wavefront_probe: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(build_variant, VARIANTS)))
    cases = {"b1": inputs(mb_w, mb_h, 1, dev),
             "b4": inputs(mb_w, mb_h, 4, dev)}
    cases.update({k: inputs(mb_w, mb_h, 1, dev, kind)
                  for k, kind in KINDS.items()})
    out = {"gpu": smi, "frame": f"{mb_w}x{mb_h} MBs, synthetic_abi",
           "reps": REPS, "variants": {}}
    cols = [f"k{i}_{c}_ms" for i in (1, 2, 5, 6) for c in cases]
    print(f"wavefront_probe on {smi}: ms per launch, mean of {REPS}")
    print(f"  {'variant':14s} " + " ".join(f"{c[:-3]:>9s}" for c in cols)
          + f" {'CCTL':>5s}")
    build.load(libs["as_built"])        # K2's input: K1's exact output
    intra = {case: intra_phase(a, *res, None, None, None, mb_w, mb_h)
             for case, (a, res, _) in cases.items()}
    for name, lib in libs.items():
        build.load(lib)                 # the wrappers now call this variant
        row = {"cctl": cctl_count(lib)}
        for case, (a, res, tables) in cases.items():
            for ki, intra_fn, kd, deblock_fn in PAIRS:
                row[f"k{ki}_{case}_ms"] = cuda_ms(
                    lambda: intra_fn(a, *res, None, None, None, mb_w, mb_h),
                    REPS)
                planes = tuple(p.clone() for p in intra[case])
                row[f"k{kd}_{case}_ms"] = cuda_ms(
                    lambda: deblock_fn(*planes, tables, mb_w, mb_h), REPS)
        out["variants"][name] = row
        print(f"  {name:14s} " + " ".join(f"{row[c]:9.4f}" for c in cols)
              + f" {row['cctl']:5d}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
