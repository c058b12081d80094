"""Error concealment for lost slices (SURVEY.md §2 `erc_*.c` row).

JM-lineage concealment repairs pictures whose slices were lost or failed
to parse: inter pictures copy co-located pixels from the nearest
reference ("frame copy", zero-MV P prediction); pictures with no
references fall back to flat DC intra fill.  Concealment has no
bit-exactness contract (the reference output for corrupt streams is
decoder-defined); deblocking is disabled over concealed MBs so repaired
regions do not bleed into parsed ones.

Enable with `Decoder(conceal=True)`: slice parse errors are swallowed,
uncovered macroblocks are patched in the frame ABI, and
`Decoder.concealed` records (frame_idx, n_concealed_mbs) per repaired
picture.
"""

from __future__ import annotations

import numpy as np

from .ops.abi import CONCEAL_SLICE, KIND_I16, KIND_P


def slice_coverage(pic) -> np.ndarray:
    """[mb_h, mb_w] bool: True where an MB was parsed from a real slice."""
    sm = pic.slice_map if hasattr(pic, "slice_map") else pic.a["slice_map"]
    return np.asarray(sm) >= 0


def conceal_abi(abi, covered: np.ndarray, ref_slot: int,
                col_mv: np.ndarray | None = None) -> int:
    """Patch uncovered MBs in-place.  ref_slot: device DPB slot of the
    nearest reference picture, or -1 if none (intra DC fill).
    col_mv: optional [h4, w4, 2] co-located motion field of that
    reference — concealed MBs then copy the co-located motion instead of
    zero-MV frame copy (JM-lineage erc motion extrapolation: a panning
    scene keeps moving through the repair instead of freezing).
    Returns the number of concealed MBs."""
    miss = ~covered.reshape(-1)
    n_miss = int(miss.sum())
    if n_miss == 0:
        return 0
    idx = np.nonzero(miss)[0]
    # wipe any partial parse state for these MBs
    for k in ("luma4", "luma8", "luma_dc", "chroma_dc", "chroma_ac",
              "nz", "tr8", "pcm"):
        abi[k][idx] = 0
    abi["qp"][idx] = 26
    # no filtering over repairs: disable deblock for the concealed MBs AND
    # their right/below neighbors — a parsed neighbor owns the shared edge
    # and would otherwise mix concealed pixels ~3px into the parsed region
    grow = ~covered
    grow[:, 1:] |= ~covered[:, :-1]
    grow[1:, :] |= ~covered[:-1, :]
    gidx = np.nonzero(grow.reshape(-1))[0]
    # dense ABI path reads disable_idc per-MB; the wire path renormalizes
    # disable_idc to per-slice rows, so the override ALSO goes into the
    # per-MB deblock_off flag, which the wire ships verbatim (a parsed
    # right/below neighbor owns the shared edge and must not be filtered,
    # or concealed pixels bleed ~3px into the parsed region)
    abi["disable_idc"][gidx] = 1
    abi["deblock_off"][gidx] = 1
    if ref_slot >= 0:
        abi["kind"][idx] = KIND_P
        abi["mv"][idx] = 0
        if col_mv is not None:
            # co-located 4x4 motion, regrouped to [nMB, 4, 4, 2]
            h4, w4 = col_mv.shape[:2]
            mb_h, mb_w = h4 // 4, w4 // 4
            per_mb = (np.asarray(col_mv, np.int32)
                      .reshape(mb_h, 4, mb_w, 4, 2)
                      .transpose(0, 2, 1, 3, 4)
                      .reshape(mb_h * mb_w, 4, 4, 2))
            abi["mv"][idx, :, :, 0, :] = per_mb[idx]
        abi["refslot"][idx] = -1
        abi["refslot"][idx, :, :, 0] = ref_slot
        abi["refid"][idx] = -1
        abi["refid"][idx, :, :, 0] = 0
        # identity weights: route through the reserved all-identity weight
        # table row (concealment has no bit-exactness contract, and
        # disable_idc above keeps deblock off these MBs)
        abi["refidx"][idx] = -1
        abi["refidx"][idx, :, :, 0] = 0
        abi["slice_id"][idx] = CONCEAL_SLICE
        abi["wtab"][CONCEAL_SLICE] = 0
        abi["wtab"][CONCEAL_SLICE, ..., 0] = 1
        abi["wtab"][CONCEAL_SLICE, ..., 2] = 1
        abi["slogwd"][CONCEAL_SLICE] = 0
        if "wp" in abi:
            # slice-row overflow frame (dense per-cell weights bypass
            # the wtab gather): set identity on the concealed cells too
            abi["wp"][idx] = 0
            abi["wp"][idx, ..., 0] = 1   # weight 1, offset 0, both lists
            abi["logwd"][idx] = 0
    else:
        abi["kind"][idx] = KIND_I16
        abi["i16_mode"][idx] = 2         # DC
        abi["chroma_mode"][idx] = 0      # DC
        abi["mb_avail"][idx] = 0         # no neighbors -> flat 128
    return n_miss


def nearest_ref_slot(dpb, poc: int) -> int:
    """Device slot of the reference picture nearest in POC; -1 if none."""
    p = nearest_ref_pic(dpb, poc)
    return -1 if p is None else p.slot


def nearest_ref_pic(dpb, poc: int):
    """The reference picture nearest in POC, or None."""
    cands = [p for p in dpb.pics
             if p.is_ref and p.slot >= 0 and not p.non_existing]
    if not cands:
        return None
    return min(cands, key=lambda p: abs(p.poc - poc))
