"""Wrapper of the wire unpack kernel K12 (csrc/unpack_wire.cu).

Replaces no pallas_call: the reference unpacks the wire in XLA
(arrow_h264_tpu/ops/wire.py::unpack_wire_frame, jitted and vmapped by
unpack_fn).  The plain version is ops/wire.py::unpack_wire_plain, ~110
eager torch launches a call.  `unpack_wire` gives the same dict: K12
writes every key but the bm8 coefficient classes, which K8
(ops/kernels/unpack_bm8.py) expands, one call for all of them.

`plan` lays K12's work out as a table of segments, one an output key (and
one for each key's sparse rows): the op of csrc/unpack_wire.cu that makes
its words, its rows and words a row, the wire section it reads, its first
block, where its words go in the one int32 allocation that holds every
output (K8's classes included, after K12's keys), and the multiplier and
shift that give a word's row without a division.  A block of the kernel
stages the rows it reads from the [B, total] wire (a lane's row stride
apart) in shared memory, so the wrapper copies nothing, and writes each
output word once (launch 1) but the words of MBs that a sparse row
covers, written again by launch 2, 4 words a store.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..abi import MAX_SLICES
from ..wire import (
    _COEFF_FIELDS, _COEFF_SHAPES, _IDENTITY_WTAB, _WTAB_COLS, _offsets,
    unpack_wire_plain, wire_total,
)
from ..transforms import device_copy
from . import LAUNCHES, build, cuda_device
from . import unpack_bm8 as k8

# csrc/unpack_wire.cu's `enum Op`, in order
OPS = ("kind", "qp", "slice_id", "tr8", "mb_avail", "i16_mode",
       "chroma_mode", "disable_idc", "alpha_off", "beta_off", "nz", "slogwd",
       "i4_modes", "i4_avail", "i8_modes", "i8_avail", "mv_base", "mv_rows",
       "refidx_base", "refidx_rows", "refid_base", "refid_rows",
       "refslot_base", "refslot_rows", "u8", "i16", "i32", "wtab")
OP = {name: code for code, name in enumerate(OPS)}
# csrc/unpack_wire.cu's Seg, field by field (int64 each)
FIELDS = ("op", "rows", "wpm", "block0", "src", "row_bytes", "idx", "nidx",
          "lane_words", "out", "mul", "shift", "block_words")
BLOCK_WORDS = 256 * 4 * 4  # csrc/unpack_wire.cu kBlockWords: kThreads x 4
                           # x kGroups, the output words of a block
STAGE_BYTES = 6 * BLOCK_WORDS + 32   # csrc/unpack_wire.cu kStageBytes
MAX_SEGS = 32              # csrc/unpack_wire.cu kMaxSegs, a launch

# (key and op, words an MB) of the fields made from an MB's meta6 row
_META = (("kind", 1), ("qp", 1), ("slice_id", 1), ("tr8", 1),
         ("mb_avail", 3), ("i16_mode", 1), ("chroma_mode", 1),
         ("disable_idc", 1), ("alpha_off", 1), ("beta_off", 1))
# (key and op, shape an MB) of the intra side-info, from an MB's 40 bytes
_INTRA = (("i4_modes", (16,)), ("i4_avail", (16, 4)), ("i8_modes", (4,)),
          ("i8_avail", (4, 4)))
# (key and op prefix, shape an MB, the sections the words come from: mv or
# ref, of mv_base/ref_base, nu_mv/nu_ref or mv16/ref8)
_INTER = (("mv", (4, 4, 2, 2), "mv"), ("refidx", (4, 4, 2), "ref"),
          ("refid", (4, 4, 2), "ref"), ("refslot", (4, 4, 2), "ref"))


def row_divisor(wpm: int) -> tuple[int, int]:
    """(mul, shift) with (i * mul) >> shift == i // wpm for every
    0 <= i < 2**31 (Granlund and Montgomery's round-up method)."""
    shift = 31 + (wpm - 1).bit_length()
    return -(-(1 << shift) // wpm), shift


def block_words(op: str, wpm: int, src: int, row_bytes: int) -> int:
    """The words a block of the kernel makes of a segment: BLOCK_WORDS, or
    fewer (a multiple of 4) where the most rows that many words touch
    would not fit the block's staging buffer with the 30 bytes of its
    16-byte alignment (the weight table's rows are read in place)."""
    if src < 0 or op == "wtab":
        return BLOCK_WORDS
    fit = (STAGE_BYTES - 30) // row_bytes          # rows a block stages
    # n words touch at most (n + wpm - 2) // wpm + 1 rows
    bw = min(BLOCK_WORDS, ((fit - 1) * wpm + 1) // 4 * 4)
    if bw < 4:
        raise ValueError(f"unpack_wire: rows of {row_bytes} bytes overflow "
                         "a block's staging buffer")
    return bw


class Plan(NamedTuple):
    """K12's work for one (spec, n, B): `outputs` [(key, shape of a lane,
    word offset in the allocation, or None: a bm8 class for K8, or the
    identity weight table)], the segment table `segs` [nseg, 10] int64
    (launch 1's `n1` segments, then launch 2's), each launch's blocks a
    lane, and the allocation's words.  What the wrapper's host work needs
    of the layout is worked out here, once a spec: `total`, the wire's
    bytes a lane; `slice8`, its slice table's offset; `split`, the sizes
    that cut the allocation into the outputs' regions and their padding,
    and `pieces`, each output's index among them (None: not K12's);
    `bm8`, each bm8 class's (key, its piece, and its layout for K8: the
    byte offsets of its idx, bm and val sections in a lane, br, bv, grid,
    w, and its word offset in the allocation), after K12's regions."""
    outputs: tuple
    segs: np.ndarray
    n1: int
    blocks1: int
    blocks2: int
    words: int
    total: int
    slice8: int
    split: tuple
    pieces: tuple
    bm8: tuple


@functools.lru_cache(maxsize=64)
def plan(spec, n: int, B: int) -> Plan:
    """The segment table of K12 for B lanes of n MBs laid out per spec."""
    table, total = _offsets(spec, n)
    sd = dict((f, (s, b)) for f, s, b in spec)
    outputs, segs = [], ([], [])
    words = 0

    def sec(name):
        """(byte offset, bytes a row) of wire section `name`."""
        off, dt, shape = table[name]
        return off, int(np.prod(shape[1:])) * np.dtype(dt).itemsize

    def key(name, shape, *parts):
        """Output `name` ([B, *shape] int32), made by `parts`: (launch,
        op, rows, wpm, src, row_bytes[, idx, nidx]), words a lane
        rows x wpm (launch 1) or n x wpm (launch 2: rows of a sparse
        section over their MBs)."""
        nonlocal words
        lane_words = int(np.prod(shape))
        outputs.append((name, tuple(shape), words))
        for launch, op, rows, wpm, src, row_bytes, *idx in parts:
            idx, nidx = idx or (-1, 0)
            segs[launch].append([OP[op], rows, wpm, 0, src, row_bytes, idx,
                                 nidx, lane_words, words, *row_divisor(wpm),
                                 block_words(op, wpm, src, row_bytes)])
        words += -(-B * lane_words // 4) * 4    # 16-byte aligned regions

    for name, wpm in _META:
        key(name, (n, wpm) if wpm > 1 else (n,), (0, name, n, wpm,
                                                  *sec("meta6")))
    # the slice table as one row
    key("slogwd", (MAX_SLICES, 2),
        (0, "slogwd", 1, 2 * MAX_SLICES, sec("slice8")[0], 6 * MAX_SLICES))
    key("nz", (n, 4, 4), (0, "nz", n, 16, *sec("meta6")))

    sch, b = sd["intra"]
    for name, shape in _INTRA:
        wpm = int(np.prod(shape))
        parts = [(0, name, n, wpm, *(sec("in_ext") if sch == "dense"
                                     else (-1, 0)))]
        if sch == "sparse":
            parts.append((1, name, b, wpm, *sec("in_ext"),
                          sec("in_idx")[0], b))
        key(name, (n,) + shape, *parts)

    sch, b = sd["inter"]
    for name, shape, part in _INTER:
        wpm = int(np.prod(shape))
        if sch == "base":
            parts = [(0, name + "_base", n, wpm, *sec(part + "_base"))]
            if b:
                parts.append((1, name + "_rows", b, wpm, *sec("nu_" + part),
                              sec("nu_idx")[0], b))
        else:   # dense: the full-grid rows; zero: no source
            parts = [(0, name + "_rows", n, wpm, *(
                sec("mv16" if part == "mv" else "ref8") if sch == "dense"
                else (-1, 0)))]
        key(name, (n,) + shape, *parts)

    for f, name, cpm, w in _COEFF_FIELDS:
        sch, _ = sd[f]
        shape = (n,) + _COEFF_SHAPES[f]
        if sch == "bm8":
            outputs.append((name, shape, None))   # K8's
        elif sch in ("dense", "dense16"):
            # the class's [grid, w] rows, cpm of them an MB
            off, row_bytes = sec(f + "_dense")
            key(name, shape, (0, "i16" if sch == "dense16" else "i32", n,
                              cpm * w, off, cpm * row_bytes))

    sch, b = sd["pcm"]
    if sch == "dense":
        key("pcm", (n, 384), (0, "u8", n, 384, *sec("pcm_val")))
    elif sch == "sparse":
        key("pcm", (n, 384), (0, "u8", n, 384, -1, 0),
            (1, "u8", b, 384, *sec("pcm_val"), sec("pcm_idx")[0], b))

    sch, b = sd["wtab"]
    if sch == "zero":
        outputs.append(("wtab", tuple(_IDENTITY_WTAB.shape), None))
    else:
        key("wtab", tuple(_IDENTITY_WTAB.shape),
            (0, "wtab", MAX_SLICES, _WTAB_COLS, *sec("wt_val"),
             sec("wt_idx")[0], b))

    blocks = []
    for launch, group in enumerate(segs):
        if len(group) > MAX_SEGS:
            raise ValueError(f"unpack_wire: {len(group)} segments in a "
                             f"launch, at most {MAX_SEGS}")
        block0 = 0
        for s in group:
            _, rows, wpm, _, _, _, _, _, lane_words, *_, bw = s
            if max(rows * wpm, lane_words) >= 2**31:
                raise ValueError(f"unpack_wire: {rows} x {wpm} words in "
                                 "a lane's segment")
            if launch and wpm % 4:
                raise ValueError(f"unpack_wire: sparse rows of {wpm} words,"
                                 " not a multiple of 4")
            s[3] = block0
            # launch 1's blocks start 0-3 words before the segment, where
            # its lane's words are not 16-byte aligned
            pad = 3 if not launch and lane_words % 4 else 0
            block0 += -(-(rows * wpm + pad) // bw)
        blocks.append(block0)
    n1 = len(segs[0])
    segs = np.array(segs[0] + segs[1], np.int64).reshape(-1, len(FIELDS))
    segs.setflags(write=False)
    split, pieces, at_end = [], [], 0
    for _, shape, at in outputs:
        if at is None:
            pieces.append(None)
            continue
        if at > at_end:                           # the padding before it
            split.append(at - at_end)
        pieces.append(len(split))
        split.append(B * int(np.prod(shape)))
        at_end = at + split[-1]
    split.append(words - at_end)
    bm8 = []
    for f, name, cpm, w in _COEFF_FIELDS:
        if sd[f][0] == "bm8":
            br, bv = sd[f][1]
            bm8.append((name, len(split), (
                table[f + "_idx"][0], table[f + "_bm"][0],
                table[f + "_val"][0], br, bv, n * cpm, w, words)))
            split.append(B * n * cpm * w)        # a multiple of 4
            words += split[-1]
    return Plan(tuple(outputs), segs, n1, *blocks, words, total,
                sec("slice8")[0], tuple(split), tuple(pieces), tuple(bm8))


@functools.lru_cache(maxsize=64)
def bm8_table(spec, n: int, B: int, stride: int) -> k8.Table:
    """K8's table of the bm8 classes of `plan(spec, n, B)`, for B lanes
    `stride` bytes apart in the wire buffer."""
    return k8.class_table([(i, b, v, stride, stride, stride, *rest)
                           for _, _, (i, b, v, *rest) in
                           plan(spec, n, B).bm8], B)


def device_launches(spec, n: int) -> int:
    """Kernels one call on this spec puts on the card: launch 1, and
    launch 2 where a section ships sparse rows (K8's not counted)."""
    return 1 + (plan(spec, n, 1).blocks2 > 0)


def bm8_launches(spec, n: int) -> int:
    """K8's kernels one unpack_wire call on this spec puts on the card:
    none without a bm8 class, else its scan and its expansion."""
    return k8.device_launches(bm8_table(spec, n, 1, 0))


def bm8_keys(spec) -> set:
    """The ABI keys of the coefficient classes that `spec` ships as bm8
    (K8's outputs)."""
    sd = dict((f, s) for f, s, _ in spec)
    return {key for f, key, _, _ in _COEFF_FIELDS if sd[f] == "bm8"}


def _checked(buf, mb_w: int, mb_h: int, spec):
    """(buf's plan) after checking that buf is a [B, total] uint8 wire
    buffer on the card that the kernels take; raise otherwise."""
    if buf.dtype != torch.uint8:
        raise TypeError(f"unpack_wire: buffer dtype {buf.dtype}, expected "
                        "torch.uint8")
    B = buf.shape[0] if buf.dim() == 2 else 0
    p = plan(spec, mb_w * mb_h, B) if 0 < B < 2**16 else None
    if p is None or buf.shape[1] != p.total:
        raise ValueError(f"unpack_wire: buffer {tuple(buf.shape)}, expected "
                         f"[B, {wire_total(spec, mb_w * mb_h)}], "
                         "0 < B < 65536")
    if buf.stride(1) != 1 or buf.stride(0) % 4 or buf.data_ptr() % 4 \
            or not 0 <= buf.stride(0) < 2**31:
        raise ValueError(f"unpack_wire: buffer strides {buf.stride()} at "
                         f"address {buf.data_ptr()}: a lane's bytes must "
                         "be contiguous, lanes and the address 4-byte "
                         "aligned")
    return p


def _expand_bm8(buf, out, regions, n: int, spec, p) -> dict:
    """K8's one call over every bm8 class of the round, into their
    regions of `out` (`regions`: out split per plan p) -> {key: [B, ...]
    view}."""
    B = buf.shape[0]
    if p.bm8:
        k8.launch(buf.data_ptr(), out, bm8_table(spec, n, B, buf.stride(0)),
                  B, buf.device)
    shapes = {name: shape for name, shape, _ in p.outputs}
    return {name: regions[piece].view((B,) + shapes[name])
            for name, piece, _ in p.bm8}


def unpack_bm8_round(buf, mb_w: int, mb_h: int, spec) -> dict:
    """The bm8 classes of unpack_wire's dict alone: on a CUDA device K8's
    one call (in an allocation laid out as unpack_wire's), on the CPU the
    plain version."""
    if cuda_device(buf) is None:
        keys = bm8_keys(spec)
        return {k: v for k, v in unpack_wire_plain(buf, mb_w, mb_h,
                                                   spec).items()
                if k in keys}
    p = _checked(buf, mb_w, mb_h, spec)
    out = torch.empty(p.words, dtype=torch.int32, device=buf.device)
    return _expand_bm8(buf, out, out.split(p.split), mb_w * mb_h, spec, p)


def unpack_wire(buf, mb_w: int, mb_h: int, spec, bm8: bool = True) -> dict:
    """ops/wire.py::unpack_wire_plain: wire buffers buf [B, total] uint8
    (one lane a row, rows may lie apart) laid out per `spec` -> the dense
    ABI dict [B, ...] int32.  On a CUDA device K12 and, where the round
    ships a bm8 class, one call of K8 for all of them, both writing into
    one allocation; on the CPU the plain version.  bm8=False leaves the
    bm8 classes out (K12 alone)."""
    dev = cuda_device(buf)
    if dev is None:
        out = unpack_wire_plain(buf, mb_w, mb_h, spec)
        return {k: v for k, v in out.items()
                if bm8 or k not in bm8_keys(spec)}
    p = _checked(buf, mb_w, mb_h, spec)
    B = buf.shape[0]
    out = torch.empty(p.words, dtype=torch.int32, device=dev)
    fn = build.function("unpack_wire_launch", 3, 7)
    with torch.cuda.device(dev):
        err = fn(buf.data_ptr(), out.data_ptr(), p.segs.ctypes.data,
                 len(p.segs), p.n1, p.blocks1, p.blocks2, B, buf.stride(0),
                 p.slice8, torch.cuda.current_stream().cuda_stream)
    build.check("unpack_wire_launch", err)
    LAUNCHES["unpack_wire"] += 1
    regions = out.split(p.split)
    classes = _expand_bm8(buf, out, regions, mb_w * mb_h, spec, p) \
        if bm8 else {}
    result = {}
    for (name, shape, _), piece in zip(p.outputs, p.pieces):
        if piece is not None:
            result[name] = regions[piece].view((B,) + shape)
        elif name == "wtab":
            # no lane ships a row: the cached identity, lane stride 0
            result[name] = device_copy(_IDENTITY_WTAB, dev).expand(
                (B,) + shape)
        elif bm8:
            result[name] = classes[name]
    return result
