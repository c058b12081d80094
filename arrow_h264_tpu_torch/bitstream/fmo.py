"""FMO slice-group maps (spec 8.2.2; JM-lineage fmo.c, SURVEY.md §2
"FMO / ASO" row).

Derives MbToSliceGroupMap for map types 0..6.  Progressive 4:2:0 only
(frame_mbs_only), so map units ARE macroblocks (spec 8.2.2.8).  Types
3..5 depend on the per-slice slice_group_change_cycle, so the map is
derived per slice; the static types cache trivially upstream.

Decode order with FMO: a slice starts at first_mb_in_slice and walks
the MBs of that address's slice group in raster order (next_mb_address,
spec 8.2.2.8).  Neighbor availability needs NO extra logic: a neighbor
is available iff it is already decoded and in the same slice, which the
parser's slice_map test already expresses.
"""

from __future__ import annotations

import numpy as np


def map_units_in_slice_group0(pps, n_units: int, change_cycle: int) -> int:
    return min(change_cycle * pps.slice_group_change_rate, n_units)


def mb_slice_group_map(sps, pps, change_cycle: int = 0) -> np.ndarray:
    """MbToSliceGroupMap [n] int32 for one slice's view of the picture."""
    W = sps.pic_width_in_mbs
    H = sps.pic_height_in_map_units
    n = W * H
    num = pps.num_slice_groups
    t = pps.slice_group_map_type
    m = np.zeros(n, np.int32)
    if num == 1:
        return m
    if t == 0:                                    # interleaved (8.2.2.1)
        i = 0
        while i < n:
            for g in range(num):
                for _ in range(pps.run_length[g]):
                    if i >= n:
                        break
                    m[i] = g
                    i += 1
    elif t == 1:                                  # dispersed (8.2.2.2)
        idx = np.arange(n)
        m = (((idx % W) + (((idx // W) * num) // 2)) % num).astype(np.int32)
    elif t == 2:                                  # fg + bg (8.2.2.3)
        m[:] = num - 1
        for g in range(num - 2, -1, -1):
            ytl, xtl = pps.top_left[g] // W, pps.top_left[g] % W
            ybr, xbr = pps.bottom_right[g] // W, pps.bottom_right[g] % W
            for y in range(ytl, min(ybr, H - 1) + 1):
                m[y * W + xtl:y * W + min(xbr, W - 1) + 1] = g
    elif t == 3:                                  # box-out (8.2.2.4)
        mu0 = map_units_in_slice_group0(pps, n, change_cycle)
        cd = pps.slice_group_change_direction_flag
        m[:] = 1
        x = (W - cd) // 2
        y = (H - cd) // 2
        left = right = x
        top = bottom = y
        xdir, ydir = cd - 1, cd
        k = 0
        while k < mu0:
            vacant = m[y * W + x] == 1
            if vacant:
                m[y * W + x] = 0
                k += 1
            if xdir == -1 and x == left:
                left = max(left - 1, 0)
                x = left
                xdir, ydir = 0, 2 * cd - 1
            elif xdir == 1 and x == right:
                right = min(right + 1, W - 1)
                x = right
                xdir, ydir = 0, 1 - 2 * cd
            elif ydir == -1 and y == top:
                top = max(top - 1, 0)
                y = top
                xdir, ydir = 1 - 2 * cd, 0
            elif ydir == 1 and y == bottom:
                bottom = min(bottom + 1, H - 1)
                y = bottom
                xdir, ydir = 2 * cd - 1, 0
            else:
                x, y = x + xdir, y + ydir
    elif t == 4:                                  # raster wipe (8.2.2.5)
        mu0 = map_units_in_slice_group0(pps, n, change_cycle)
        cd = pps.slice_group_change_direction_flag
        size_ul = n - mu0 if cd else mu0
        idx = np.arange(n)
        m = np.where(idx < size_ul, cd, 1 - cd).astype(np.int32)
    elif t == 5:                                  # column wipe (8.2.2.6)
        mu0 = map_units_in_slice_group0(pps, n, change_cycle)
        cd = pps.slice_group_change_direction_flag
        size_ul = n - mu0 if cd else mu0
        k = np.arange(n).reshape(W, H).T.reshape(n)   # column-major rank
        m = np.where(k < size_ul, cd, 1 - cd).astype(np.int32)
    elif t == 6:                                  # explicit (8.2.2.7)
        ids = np.asarray(pps.slice_group_id or [], np.int32)
        if len(ids) < n:
            ids = np.concatenate([ids, np.zeros(n - len(ids), np.int32)])
        m = ids[:n].copy()
    else:
        raise ValueError(f"bad slice_group_map_type {t}")
    return m


def next_mb_table(sgmap: np.ndarray) -> np.ndarray:
    """Dense successor table: next_mb[a] = NextMbAddress(a) for every
    MB address (spec 8.2.2.8); the last MB of each slice group maps to
    n (end-of-slice sentinel).  The C++ slice loop walks this table
    instead of raster +1, which is its entire FMO support."""
    n = len(sgmap)
    nxt = np.full(n, n, np.int32)
    for g in np.unique(sgmap):
        idx = np.flatnonzero(sgmap == g)
        nxt[idx[:-1]] = idx[1:]
    return nxt


def next_mb_address(sgmap: np.ndarray, addr: int) -> int:
    """NextMbAddress (spec 8.2.2.8): next MB of addr's slice group."""
    g = sgmap[addr]
    i = addr + 1
    n = len(sgmap)
    while i < n and sgmap[i] != g:
        i += 1
    return i
