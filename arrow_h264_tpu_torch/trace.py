"""Structured decode trace (JSONL) — the JM `TRACE` analog (SURVEY.md §5).

JM writes every syntax element to trace_dec.txt; the TPU-native analog
records one JSON line per slice header and per macroblock with the decoded
syntax summary (type, qp, cbp, intra modes, MVs, refs, coeff counts).
Two decoder runs — or this decoder vs a reference — can be diffed per MB
to localize entropy bugs without pixel comparison.

Enable with `Decoder(trace="out.jsonl")`, the CLI `--trace out.jsonl`, or
the env var ARROW_H264_TRACE=<path>.
"""

from __future__ import annotations

import json
import os

import numpy as np


def trace_target(explicit=None):
    """Resolve the trace sink: explicit path/file-object or env var."""
    t = explicit if explicit is not None else os.environ.get(
        "ARROW_H264_TRACE")
    if t is None:
        return None
    if hasattr(t, "write"):
        return t
    return open(t, "a")


def trace_slice_header(fh, hdr, poc: int, frame_idx: int) -> None:
    rec = {
        "t": "slice",
        "frame": frame_idx,
        "poc": poc,
        "first_mb": hdr.first_mb_in_slice,
        "type": hdr.slice_type,
        "frame_num": hdr.frame_num,
        "idr": bool(hdr.is_idr),
        "qp_delta": hdr.slice_qp_delta,
        "ref_idc": hdr.nal_ref_idc,
        "num_ref_l0": hdr.num_ref_idx_l0_active,
        "num_ref_l1": hdr.num_ref_idx_l1_active,
        "disable_deblock": hdr.disable_deblocking_filter_idc,
    }
    fh.write(json.dumps(rec) + "\n")


def trace_frame_abi(fh, abi, mb_w: int, mb_h: int, frame_idx: int) -> None:
    """One JSONL record per MB from the packed frame ABI (works for both
    the Python and C++ entropy paths, which share the ABI contract)."""
    kind = np.asarray(abi["kind"]).reshape(-1)
    qp = np.asarray(abi["qp"]).reshape(-1)
    nz = np.asarray(abi["nz"]).reshape(len(kind), -1)
    mv = np.asarray(abi["mv"]).reshape(len(kind), 16, 2, 2)
    refid = np.asarray(abi["refid"]).reshape(len(kind), 16, 2)
    i4 = np.asarray(abi["i4_modes"]).reshape(len(kind), -1)
    i16 = np.asarray(abi["i16_mode"]).reshape(-1)
    cm = np.asarray(abi["chroma_mode"]).reshape(-1)
    tr8 = np.asarray(abi["tr8"]).reshape(-1)
    for i in range(len(kind)):
        rec = {
            "t": "mb",
            "frame": frame_idx,
            "mb": i,
            "xy": [i % mb_w, i // mb_w],
            "kind": int(kind[i]),
            "qp": int(qp[i]),
            "nz": int(nz[i].sum()),
            "tr8": int(tr8[i]),
        }
        if kind[i] <= 3:                      # intra categories
            rec["i16"] = int(i16[i])
            rec["cmode"] = int(cm[i])
            rec["i4"] = [int(v) for v in i4[i]]
        else:
            used = refid[i] >= 0
            if used.any():
                rec["ref"] = refid[i].tolist()
                rec["mv"] = mv[i].tolist()
        fh.write(json.dumps(rec) + "\n")


def trace_se_target(explicit=None):
    """Sink for the syntax-element-level trace (``--trace-se`` /
    ARROW_H264_TRACE_SE): the JM trace_dec.txt analog."""
    t = explicit if explicit is not None else os.environ.get(
        "ARROW_H264_TRACE_SE")
    if t is None:
        return None
    if hasattr(t, "write"):
        return t
    return open(t, "a")


def dump_se_log(fh, log, frame_idx: int, slice_idx: int) -> None:
    """Write one entropy-decode-sequence record per primitive read.

    Format (text, one line per read, JM-trace-style):
        SE <frame> <slice> <kind> <bitpos> <nbits> <value>
    kinds: u/ue/se/te (bit reads), cab (CABAC decision: nbits column is
    the context index), cby (CABAC bypass).  Diffing two traces localizes
    the first diverging syntax element of an entropy bug.
    """
    w = fh.write
    for kind, pos, n, v in log:
        w(f"SE {frame_idx} {slice_idx} {kind} {pos} {n} {v}\n")
    fh.flush()
