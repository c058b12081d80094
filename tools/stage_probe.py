"""Where the time of the bm8 expansion K8 (csrc/unpack_bm8.cu) and the
inter combine K10 (csrc/inter_combine.cu) goes, on one GPU.

    python tools/stage_probe.py [--out FILE.json]

Builds variants of the two sources in the checkout (text edits of copies,
each variant one library of that source alone under
arrow_h264_tpu_torch/_build/probe/) and times each through the port's
wrappers with chip_smoke.kernel_ms (launches queued behind a device
sleep).  A variant whose edits do not apply to the checkout's sources is
skipped, so the same script splits an older tree's kernels (the `old_*`
variants) and the current ones (the others).  Inputs, made once with the
library built from the sources:
  K8   the bm8 classes of the wire rounds of the smoke stream's picture 1
       (1920x1088, B = 1), its pictures 1-4 (B = 4) and of the uhd round
       (conf_c5's picture 1 in four lanes, 3840x2160, B = 4), all of a
       round's classes as the tree expands them: one call for the round
       where the tree has ops/kernels/unpack_wire.py::unpack_bm8_round,
       else one unpack_bm8 call a class
  K10  the smoke stream's first B picture's wire upload (K3's and K4's
       lists over the DPB it reads, its own residual; 1920x1088, B = 1)
       and random_weighted_abi with per-slice tables over random
       predictions and residuals at 3840x2160, B = 4
Variants of the older tree's kernels (three launches a K8 class, a
thread a 4x4 cell in K10 with scalar accesses):
  old_expand_zeros   K8's expand launch stores zeros without reading the
                     row map (its store floor)
  old_expand_no_vals K8's expand without the value loads
  old_stores_only    K10 stores zeros for every cell, word by word
  old_int4_zeros     K10 stores zeros for every cell, a row as one int4
                     (chroma int2)
  old_no_stores      K10 loads and combines, stores nothing
  old_one_weight     K10 reads every cell's weights from one table entry
Variants of the current kernels (two launches a K8 call, a thread a
4x4 cell in K10 with a row an access):
  scan_only          K8's first launch alone
  expand_only        K8's second launch alone (over the row map, first
                     positions and totals the last call left: the
                     caching allocator hands the call the same scratch)
  stores_only        K8's second launch stores zeros and nothing else
  rows_then_zeros    K8's second launch reads its rows, then stores
                     zeros as for a tile without a live row
  no_values          K8 without the value loads (a group's values are
                     its position's bytes)
  zeros_stores       K10 stores zeros for every cell (int4 / int2)
  one_weight         K10 reads every cell's weights from one table entry
  no_pred            K10 without the prediction loads
  no_stores          K10 loads and combines, stores (almost) nothing
The current K8 is also timed with its expand blocks laid out for 4096
(as built), 8192 and 2048 words (TILE_WORDS).  Then one torch.profiler
session over the as-built kernels: K8's device time by kernel (each of
its launches) on its rounds.  --ptxas prints
ptxas's registers, stack frame, spills and shared memory of each kernel
of the two sources as built.  Prints a table, and writes the numbers as
JSON to FILE if --out is given.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from arrow_h264_tpu_torch.ops.kernels import build  # noqa: E402
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
from arrow_h264_tpu_torch.ops.kernels.unpack_bm8 import (  # noqa: E402
    unpack_bm8,
)
from arrow_h264_tpu_torch.ops.synthetic import (  # noqa: E402
    random_weighted_abi,
)
from arrow_h264_tpu_torch.ops.transforms import (  # noqa: E402
    make_ws_consts,
)
from chip_smoke import (  # noqa: E402
    B4, MB_H, MB_H_4K, MB_W, MB_W_4K, SEED, STREAM, kernel_ms,
    stream_abis, stream_mc_inputs, wire_round,
)

K8, K10 = "unpack_bm8.cu", "inter_combine.cu"
# the expand blocks' words (ops/kernels/unpack_bm8.py TILE_WORDS, the
# wrapper's first) that the current K8 is also timed with
TILE_WORDS = (4096, 8192, 2048)
# the older kernels' texts that the old_* variants edit
OLD_J = "  const int j = a.rowmap[(long)b * a.grid + g];\n"
OLD_VAL = "        v[i] = vals[pos < a.bv - 1 ? pos : a.bv - 1];\n"
OLD_INTRA = "  if (a.kind[mb] < kKindP) {           // intra: 0\n"
OLD_ZERO_Y = ("    for (int r = 0; r < 4; ++r)\n"
              "      for (int x = 0; x < 4; ++x) a.init_y[ry + r * W + x]"
              " = 0;\n")
OLD_ZERO_C = ("    for (int r = 0; r < 2; ++r)\n"
              "      for (int x = 0; x < 2; ++x) {\n"
              "        a.init_cb[rc + r * Wc + x] = 0;\n"
              "        a.init_cr[rc + r * Wc + x] = 0;\n"
              "      }\n")
OLD_STORE_Y = ("      a.init_y[ry + r * W + x] = clip255(v + a.res_y[ry + r "
               "* W + x]);\n")
OLD_STORE_C = ("        out[rc + r * Wc + x] = clip255(v + res[rc + r * Wc "
               "+ x]);\n")
OLD_WTAB = ("    const int32_t* p = a.wtab + (long)b * a.wtab_stride +\n"
            "                       (((long)sid * kRefs + r0) * kRefs + r1)"
            " * 12;\n")
# the current kernels' texts
NEW_LIVE = "  if (!__syncthreads_or(live)) {\n"
NEW_ROWS = "  bool live = false;\n"
NEW_GROUP = "  if (p + count > bv) {\n"
NEW_SCAN = "  if (blocks1 > 0)\n"
NEW_EXPAND = "  if (blocks2 > 0)\n"
NEW_INTRA = "  if (kind < kKindP) {                 // intra: 0\n"
NEW_WT = ("  const int4 q0 = __ldg(wt), q1 = __ldg(wt + 1), q2 = __ldg(wt + "
          "2);\n")
NEW_READ = "  const bool read0 = !only1, read1 = u1 || only1;"
NEW_STORE_Y = "  *reinterpret_cast<int4*>(out) =\n"
NEW_STORE_C = "      *reinterpret_cast<int2*>(out + rc + r * Wc) = make_int2("
# variant -> [(file, text, replacement)]; a variant applies where each
# text occurs in its file
VARIANTS = {
    "as_built": [],
    "old_expand_zeros": [(K8, OLD_J, "  const int j = -1;\n")],
    "old_expand_no_vals": [(K8, OLD_VAL, "        v[i] = pos;\n")],
    "old_stores_only": [(K10, OLD_INTRA, "  if (true) {\n")],
    "old_int4_zeros": [
        (K10, OLD_INTRA, "  if (true) {\n"),
        (K10, OLD_ZERO_Y, "    for (int r = 0; r < 4; ++r)\n"
         "      *reinterpret_cast<int4*>(a.init_y + ry + r * W) = "
         "make_int4(0, 0, 0, 0);\n"),
        (K10, OLD_ZERO_C, "    for (int r = 0; r < 2; ++r) {\n"
         "      *reinterpret_cast<int2*>(a.init_cb + rc + r * Wc) = "
         "make_int2(0, 0);\n"
         "      *reinterpret_cast<int2*>(a.init_cr + rc + r * Wc) = "
         "make_int2(0, 0);\n    }\n")],
    "old_no_stores": [
        (K10, OLD_STORE_Y, "      { const int q = clip255(v + a.res_y[ry + "
         "r * W + x]); if (q == a.B + 1000) a.init_y[ry + r * W + x] = q; "
         "}\n"),
        (K10, OLD_STORE_C, "        { const int q = clip255(v + res[rc + r "
         "* Wc + x]); if (q == a.B + 1000) out[rc + r * Wc + x] = q; }\n")],
    "old_one_weight": [(K10, OLD_WTAB, "    const int32_t* p = a.wtab;\n")],
    "scan_only": [(K8, NEW_EXPAND, "  if (false)\n")],
    "expand_only": [(K8, NEW_SCAN, "  if (false)\n")],
    "stores_only": [(K8, NEW_ROWS, NEW_ROWS + "  if (true) {\n"
                     "    int4* o = reinterpret_cast<int4*>(a.out + c.out + "
                     "((long long)b * grid + g0) * w);\n"
                     "    for (int q = threadIdx.x; q < nrows * w / 4; q += "
                     "kThreads) o[q] = make_int4(0, 0, 0, 0);\n"
                     "    return;\n  }\n")],
    "rows_then_zeros": [(K8, NEW_LIVE,
                         "  if (!__syncthreads_or(live && false)) {\n")],
    "no_values": [(K8, NEW_GROUP, "  if (true) return p;\n" + NEW_GROUP)],
    "zeros_stores": [(K10, NEW_INTRA, "  if (true) {\n")],
    "one_weight": [(K10, NEW_WT, "  const int4* wt0 = reinterpret_cast<"
                    "const int4*>(a.dense ? a.wp : a.wtab);\n"
                    "  const int4 q0 = __ldg(wt0), q1 = __ldg(wt0 + 1), "
                    "q2 = __ldg(wt0 + 2);\n")],
    "no_pred": [(K10, NEW_READ,
                 "  const bool read0 = false, read1 = false;")],
    "no_stores": [
        (K10, NEW_STORE_Y, "  if (res.x == -(1 << 30)) "
         "*reinterpret_cast<int4*>(out) =\n"),
        (K10, NEW_STORE_C, "      if (rv.x == -(1 << 30)) "
         "*reinterpret_cast<int2*>(out + rc + r * Wc) = make_int2(")],
}


def variant_sources(name: str, d: Path) -> list[Path] | None:
    """Copy the sources that variant `name` edits (as_built: both) into
    `d` with the headers, apply its edits; None where a text is missing."""
    d.mkdir(parents=True, exist_ok=True)
    for src in build.CSRC.glob("*.cuh"):
        shutil.copy(src, d / src.name)
    files = sorted({f for f, _, _ in VARIANTS[name]}) or [K8, K10]
    for f in files:
        shutil.copy(build.CSRC / f, d / f)
    for f, old, new in VARIANTS[name]:
        text = (d / f).read_text()
        if old not in text:
            return None
        (d / f).write_text(text.replace(old, new, 1))
    return [d / f for f in files]


def build_variant(name: str) -> Path | None:
    d = build.BUILD_DIR / "probe" / name
    shutil.rmtree(d, ignore_errors=True)
    srcs = variant_sources(name, d)
    if srcs is None:
        return None
    lib = d / f"lib{name}.so"
    try:
        build.compile_library(srcs, lib)
    except RuntimeError as e:
        print(f"stage_probe: variant {name} did not build:\n{e}")
        return None
    return lib


def ptxas() -> list[str]:
    """ptxas's report of each kernel of the two sources as built."""
    lines = []
    for f in (K8, K10):
        r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                            "-c", "-o", "/dev/null", str(build.CSRC / f)],
                           capture_output=True, text=True)
        lines += [f"{f}: {ln.strip()}" for ln in r.stderr.splitlines()
                  if "ptxas info" in ln or "bytes stack" in ln]
    return lines


def k8_call(buf, spec, classes, mb_w, mb_h):
    """All of a round's bm8 classes as the tree expands them."""
    if hasattr(k12, "unpack_bm8_round"):
        return partial(k12.unpack_bm8_round, buf, mb_w, mb_h, spec)
    return lambda: [unpack_bm8(idx, bm, vals, grid, w)
                    for _, idx, bm, vals, grid, w in classes]


def cases(dev) -> dict:
    """{case name: a call of K8 or K10 on its inputs}."""
    out = {}
    smoke, _ = stream_abis(STREAM.read_bytes(), dev)
    uhd, _ = stream_abis((STREAM.parent / "conf_c5.264").read_bytes(), dev)
    for name, abis, mb_w, mb_h in (
            ("k8_1080p_b1", smoke[1:2], MB_W, MB_H),
            ("k8_1080p_b4", smoke[1:1 + B4], MB_W, MB_H),
            ("k8_2160p_b4", [uhd[1]] * B4, MB_W_4K, MB_H_4K)):
        buf, spec, classes = wire_round(abis, mb_w, mb_h, dev)
        out[name] = k8_call(buf, spec, classes, mb_w, mb_h)
    del smoke, uhd
    ws = tuple(t.to(dev) for t in make_ws_consts([[16] * 16] * 6,
                                                 [[16] * 64] * 2))
    dpb_y, dpb_c, *_, (a, _) = stream_mc_inputs(STREAM.read_bytes(),
                                                dev)["B"]
    zero = torch.zeros(dpb_c.shape[:2], dtype=torch.int32, device=dev)
    pred = (mc_luma(dpb_y, a["mv"], a["refslot"], MB_W, MB_H),
            mc_chroma(dpb_c, a["mv"], a["refslot"], zero, MB_W, MB_H))
    out["k10_1080p_b1"] = partial(inter_combine, a, *pred,
                                  *residual_planes(a, MB_W, MB_H, *ws),
                                  MB_W, MB_H)
    g = torch.Generator(device=dev).manual_seed(SEED + 61)
    H, W = 16 * MB_H_4K, 16 * MB_W_4K
    a = {k: torch.from_numpy(v).to(dev) for k, v in
         random_weighted_abi(MB_W_4K, MB_H_4K, B4, SEED + 62).items()}
    pred = [torch.randint(0, 256, s, generator=g, device=dev,
                          dtype=torch.uint8)
            for s in ((B4, 2, H, W), (B4, 2, 2, H // 2, W // 2))]
    res = [torch.randint(-300, 300, s, generator=g, device=dev,
                         dtype=torch.int32)
           for s in ((B4, H, W), (B4, H // 2, W // 2), (B4, H // 2, W // 2))]
    out["k10_2160p_b4"] = partial(inter_combine, a, *pred, *res, MB_W_4K,
                                  MB_H_4K)
    return out


def launch_split(calls: dict, reps: int = 20) -> dict:
    """{case: {kernel name: mean device ms a launch}} of K8's calls, from
    one torch.profiler session (each case `reps` times, under a
    record_function range of its name)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, call in calls.items():
            with record_function(name):
                for _ in range(reps):
                    call()
            torch.cuda.synchronize()
    starts = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.name in calls and e.device_type != cuda)
    out = {}
    for k, (start, name) in enumerate(starts):
        end = starts[k + 1][0] if k + 1 < len(starts) else float("inf")
        per = {}
        for e in prof.events():
            if e.device_type == cuda and e.name not in calls \
                    and start <= e.time_range.start < end:
                n, us = per.get(e.name, (0, 0.0))
                per[e.name] = (n + 1, us + e.time_range.elapsed_us())
        out[name] = {k: {"launches": n // reps, "ms": us / n / 1e3}
                     for k, (n, us) in per.items()}
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write the numbers as JSON here")
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas's report of both sources")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("stage_probe: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    out = {"gpu": smi, "variants": {}}
    if args.ptxas:
        out["ptxas"] = ptxas()
        print("\n".join(out["ptxas"]))
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(build_variant, VARIANTS)))
    build.load()                    # the inputs' kernels: K3, K4, K9, ...
    calls = cases(dev)
    print(f"stage_probe on {smi}: kernel ms (chip_smoke.kernel_ms)")
    print(f"  {'variant':20s} " + " ".join(f"{c:>13s}" for c in calls))
    for name, lib in libs.items():
        if lib is None:
            print(f"  {name:20s} (does not apply to these sources)")
            continue
        build.load(lib)             # the wrappers now call this variant
        edits = {f for f, _, _ in VARIANTS[name]} or {K8, K10}
        row = {case: kernel_ms(call) for case, call in calls.items()
               if (K8 if case.startswith("k8") else K10) in edits}
        out["variants"][name] = row
        print(f"  {name:20s} " + " ".join(
            f"{row[c]:13.4f}" if c in row else f"{'':13s}" for c in calls))
    build.load(libs["as_built"])
    if hasattr(k12, "bm8_table"):
        for words in TILE_WORDS:
            k8.TILE_WORDS = words           # the tables laid out anew
            k12.bm8_table.cache_clear()
            row = {case: kernel_ms(call) for case, call in calls.items()
                   if case.startswith("k8")}
            out["variants"][f"tile_words_{words}"] = row
            print(f"  {'tile_words_' + str(words):20s} " + " ".join(
                f"{row[c]:13.4f}" if c in row else f"{'':13s}"
                for c in calls))
        k8.TILE_WORDS = TILE_WORDS[0]
        k12.bm8_table.cache_clear()
    split = launch_split({k: v for k, v in calls.items()
                          if k.startswith("k8")})
    out["k8_launches"] = split
    for case, per in split.items():
        print(f"  K8 launches, {case}: " + ", ".join(
            f"{k} x{v['launches']} {v['ms']:.4f} ms" for k, v in per.items()))
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
