"""Conformance gate of the PyTorch/CUDA port: decode the committed stream
of each config on the card and compare every frame with its libavcodec
golden.  The port's counterpart of tools/tpu_conformance.py.

    python tools/gpu_conformance.py [CFG ...] [--order phase|raster|both]
                                    [--batch N] [--device cuda|cpu]

Configs (tools/conformance_streams.py, tests/data/conf_cN.264): 1 QCIF
Baseline intra, 2 CIF Baseline P, 3 1280x720 Main, 4 1920x1088 High, 5
3840x2160 High, 6 CIF lossless; all six by default.  Each goes through
arrow_h264_tpu_torch.api.Decoder with each order asked for, and with
--batch N also as the N lanes of one BatchDecoder (config 5's lanes
alternate conf_c5 and batch_2160p_s1, the others repeat the config's
stream).  Every frame's MD5 must equal the stream's JSON.  One line a
config, order and decoder: BIT-EXACT, or the frames that differ (and
their differing bytes where tools/h264ref can decode the golden here);
then ALL BIT-EXACT or CONFORMANCE FAILURES.  On the card each decode
must also have launched the order's intra and deblock kernels and the
deblock-table kernel K7 and the residual kernel K9 once a picture (a
BatchDecoder round), K3/K4 and the inter combine K10 once a P/B picture
(a round with a P/B lane), the wire unpack K12 once a wire upload and
the wire's bm8 kernel K8 once for each wire upload that shipped a
coefficient class as bm8, and the reference store K11 once a store of
reference pictures (a round with a storing lane; `bm8_tally` counts
them).  Exit code 0 iff every frame is exact
and every count as it must be.

It needs only the committed streams and their JSON: no libx264 or
libavcodec, no JAX.  The default device is the card; without one it
raises, as Decoder() does (there is no CPU fallback: --device cpu asks
for the plain PyTorch versions, slow beyond CIF).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

DATA = REPO / "tests" / "data"
CONFIGS = (1, 2, 3, 4, 5, 6)
ORDERS = ("phase", "raster")
# order -> the intra and deblock kernels it launches (K3/K4 run with both)
KERNELS = {"phase": ("intra_phase", "deblock_phase"),
           "raster": ("intra_raster", "deblock_raster")}


def lanes(cfg: int, batch: int | None) -> list[str]:
    """The streams of config `cfg`: its own, or the `batch` lanes of its
    BatchDecoder."""
    if batch is None:
        return [f"conf_c{cfg}"]
    cycle = ["conf_c5", "batch_2160p_s1"] if cfg == 5 else [f"conf_c{cfg}"]
    return [cycle[i % len(cycle)] for i in range(batch)]


def load(name: str) -> tuple[bytes, dict]:
    """(the committed stream `name`, its JSON)."""
    path = DATA / f"{name}.264"
    return path.read_bytes(), json.loads(path.with_suffix(".json")
                                         .read_text())


def rounds_of(names: list[str]) -> tuple[int, int, list[int]]:
    """(rounds, rounds with a P/B picture, rounds with an IDR lane beside
    a P/B lane) of the lockstep lanes `names`, from their JSON: round k
    decodes each lane's k-th picture in decode order.  For one stream:
    its pictures and its P/B pictures."""
    metas = [load(n)[1] for n in names]
    rounds = max(len(m["structure"]) for m in metas)
    inter = [k for k in range(rounds)
             if any(m["structure"][k:k + 1] in ("P", "B") for m in metas)]
    mixed = [k for k in inter if any(k in m["idr"] for m in metas)]
    return rounds, len(inter), mixed


@contextlib.contextmanager
def bm8_tally():
    """While open, count the wire uploads that models.pipeline unpacks
    (`unpacks`: the launches K12, unpack_wire, must make) and those of
    them that ship any coefficient class as bm8 (`bm8`), from the specs
    unpack_wire is given: the launches K8 (unpack_bm8, one call for all
    of an upload's bm8 classes) must make (a dense upload unpacks
    nothing); and the reference stores
    with a storing lane that the decoders ask store_refs_fn for
    (`stores`, where models.pipeline and parallel.sharding call it): the
    launches K11 (store_refs) must make.  Yields the counts."""
    from arrow_h264_tpu_torch.models import pipeline
    from arrow_h264_tpu_torch.parallel import sharding
    tally = {"unpacks": 0, "bm8": 0, "stores": 0}
    unpack = pipeline.unpack_wire
    store = pipeline.store_refs_fn

    def counted(buf, mb_w, mb_h, spec):
        tally["unpacks"] += 1
        tally["bm8"] += any(sch == "bm8" for _, sch, _ in spec)
        return unpack(buf, mb_w, mb_h, spec)

    def counted_store(dpb_y, dpb_c, lanes, *rest):
        tally["stores"] += bool(lanes)
        return store(dpb_y, dpb_c, lanes, *rest)

    pipeline.unpack_wire = counted
    pipeline.store_refs_fn = sharding.store_refs_fn = counted_store
    try:
        yield tally
    finally:
        pipeline.unpack_wire = unpack
        pipeline.store_refs_fn = sharding.store_refs_fn = store


def want_launches(launches: dict, order: str, pictures: int, inter: int,
                  bm8: int, shards: int = 1, *, stores: int,
                  unpacks: int) -> dict:
    """The launches a decode of `pictures` pictures (BatchDecoder rounds),
    `inter` of them with a P/B picture, over `shards` shards must make:
    the order's intra and deblock kernels, K7 and K9 once a picture and
    shard, K3/K4 and K10 once an inter one, K8 `bm8` times, K11 `stores`
    times and K12 `unpacks` times (bm8_tally's counts); every other
    kernel of `launches` none."""
    want = dict.fromkeys(launches, 0)
    want.update(dict.fromkeys(KERNELS[order] + ("deblock_tables",
                                                "residual"),
                              shards * pictures),
                **dict.fromkeys(("mc_luma", "mc_chroma", "inter_combine"),
                                shards * inter),
                unpack_bm8=bm8, store_refs=stores, unpack_wire=unpacks)
    return want


def check_counts(r: dict, names: list[str], order: str, batch: bool,
                 upload: str, launches: dict) -> str:
    """'' if the card's decode `r` (of `decode`) of `names` launched each
    kernel as it must, `launches` being the wrappers' counts over it: the
    order's intra and deblock kernels, K7 and K9 once a picture (a round),
    K3/K4 and K10 once a P/B picture (a round with a P/B lane), K12 once a
    wire upload (r["unpacks"]), K8 once a wire upload that ships a bm8
    class (r["bm8"]) and K11 once a store with a storing lane
    (r["stores"], at least one), with a batch's every round
    through `upload` and a stream's every picture through the wire or
    none; else what differs."""
    rounds, inter, _ = rounds_of(names)
    want = want_launches(launches, order, rounds, inter, r["bm8"],
                         stores=r["stores"], unpacks=r["unpacks"])
    dec = r["decoder"]
    if batch:
        want_seen = (rounds, inter,
                     *((rounds, 0) if upload == "wire" else (0, rounds)),
                     rounds if upload == "wire" else 0)
        seen = (dec.rounds, dec.inter_rounds, dec.wire_rounds,
                dec.dense_rounds, r["unpacks"])
        what = "(rounds, inter, wire, dense, unpacks)"
    else:
        want_seen = (rounds, rounds if upload == "wire" else 0)
        seen = (dec.stats.frames, r["unpacks"])
        what = "(pictures, unpacks)"
    if launches == want and seen == want_seen and r["stores"] > 0:
        return ""
    return (f"launches {launches} in {what} {seen}; expected {want} in "
            f"{want_seen}")


def golden_bytes_differ(name: str, frames: dict) -> dict | None:
    """{frame: bytes that differ from libavcodec's decode} for the planar
    frames of stream `name` that `frames` holds, or None where libavcodec
    is not at hand (the committed goldens are MD5s only)."""
    try:
        from tools import streams
        golden, _, _ = streams.golden_decode(str(DATA / f"{name}.264"))
    except (OSError, subprocess.CalledProcessError):
        return None
    out = {}
    for i, f in frames.items():
        got = np.frombuffer(f, np.uint8)
        want = golden[i] if i < len(golden) else got[:0]
        n = min(got.size, want.size)
        out[i] = int(np.count_nonzero(got[:n] != want[:n])) \
            + abs(got.size - want.size)
    return out


def decode(names: list[str], order: str, device: str, batch: bool,
           upload: str = "wire") -> dict:
    """Decode the streams `names` with `order` and `upload` on `device`:
    as the lanes of one BatchDecoder if `batch`, else the one stream
    through Decoder.
    Returns {"what", "frames", "seconds", "peak_bytes" (the card's peak
    allocation, None on the CPU), "bad": [(lane, stream, frames that
    differ, the lane's error, {frame: planar bytes})], "decoder",
    "unpacks", "bm8" (bm8_tally's counts)}."""
    from arrow_h264_tpu_torch.api import Decoder
    from arrow_h264_tpu_torch.parallel.batch import BatchDecoder
    data = [load(n) for n in names]
    dec = BatchDecoder(len(names), device=device, order=order,
                       upload=upload) if batch \
        else Decoder(device=device, order=order, upload=upload)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with bm8_tally() as tally:
        if batch:
            with dec:
                outs = dec.decode([d for d, _ in data])
            errors = dec.errors
        else:
            outs = [list(dec.decode_annexb(data[0][0]))]
            errors = [None]
        if cuda:
            torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    bad = []
    for i, (frames, (_, meta), err) in enumerate(zip(outs, data, errors)):
        planar = [f.planar() for f in frames]
        md5 = [hashlib.md5(p).hexdigest() for p in planar]
        if md5 != meta["md5"] or err is not None:
            diff = [j for j in range(max(len(md5), len(meta["md5"])))
                    if md5[j:j + 1] != meta["md5"][j:j + 1]]
            bad.append((i, names[i], diff, err,
                        {j: planar[j] for j in diff if j < len(planar)}))
    what = (f"BatchDecoder({len(names)})" if batch else "Decoder") + \
        f" order={order}" + ("" if upload == "wire" else f" upload={upload}")
    return {"what": what, "frames": sum(len(o) for o in outs),
            "seconds": seconds, "bad": bad, "decoder": dec,
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda
            else None, **tally}


def config_label(cfg: int) -> str:
    meta = load(f"conf_c{cfg}")[1]
    return f"config {cfg} ({meta['width']}x{meta['height']})"


def report(label: str, r: dict) -> str:
    """The line of one decode (module docstring), headed by `label`."""
    head = (f"{label} {r['what']}: "
            f"{r['frames']} frames in {r['seconds']:.3f} s, "
            f"{r['frames'] / r['seconds']:.3f} frames/s")
    if r["peak_bytes"] is not None:
        head += f", peak {r['peak_bytes'] / 2**20:.1f} MiB allocated"
    if not r["bad"]:
        return f"{head}: BIT-EXACT"
    parts = []
    for lane, name, diff, err, planar in r["bad"]:
        counts = golden_bytes_differ(name, planar)
        where = ", ".join(f"{j} ({counts[j]} bytes)" if counts and j in counts
                          else str(j) for j in diff)
        parts.append(f"lane {lane} ({name}) frames {where} differ"
                     + ("" if err is None else f", error {err!r}"))
    return f"{head}: FAIL, " + "; ".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("configs", nargs="*", type=int, choices=CONFIGS,
                    metavar="CFG", help="configs 1-6 (default: all)")
    ap.add_argument("--order", choices=ORDERS + ("both",), default="phase")
    ap.add_argument("--batch", type=int, metavar="N",
                    help="also decode each config as N BatchDecoder lanes")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    orders = ORDERS if args.order == "both" else (args.order,)
    print(f"device: {args.device}"
          + (f" ({torch.cuda.get_device_name(0)})"
             if args.device == "cuda" and torch.cuda.is_available() else ""),
          flush=True)
    from arrow_h264_tpu_torch.ops import kernels
    ok = True
    for cfg in args.configs or CONFIGS:
        for order in orders:
            for batch in (None,) if args.batch is None else (None, args.batch):
                names = lanes(cfg, batch)
                kernels.reset_launches()
                r = decode(names, order, args.device, batch is not None)
                line = report(config_label(cfg), r)
                # on the CPU the wrappers run the plain versions and count
                # nothing
                miss = check_counts(r, names, order, batch is not None,
                                    "wire", dict(kernels.LAUNCHES)) \
                    if args.device == "cuda" else ""
                if miss:
                    line += f"; {miss}"
                ok &= not r["bad"] and not miss
                print(line, flush=True)
                del r    # its decoder's DPB would count in the next peak
    print("ALL BIT-EXACT" if ok else "CONFORMANCE FAILURES", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
