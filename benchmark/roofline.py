"""The card's peaks and the bytes a decoded picture needs.  Frozen: the
per-layer rooflines of every later PR are read against these.

`picture_bytes` counts the least that any implementation of the decode
has to move for one picture, from its display width, height and kind
(I, P or B) alone, never from what a kernel launch moves, so a later PR
that fuses, splits or renames kernels reads the same work:

- the picture's output planes, 4:2:0, written once (W x H x 3 / 2 bytes).
  A reference picture's store is these same bytes: an implementation may
  output from its reference store, so the store is not counted twice;
- for a P or B picture, the reference area that its inter MBs read: one
  picture's worth of samples (every MB predicted from one reference area
  of its own size, each byte read once; a B picture counted with one
  list, the least of its two);
- the coded-coefficient input: its least is nothing (a picture whose
  MBs are all skipped carries none), so it adds 0.

A share of the roofline is that byte count over PEAK_BYTES_PER_S, over
the kernels' time: it is bounded by bytes (the decode's integer work is
far below the card's operation peak), and counting the least keeps it
under 100 %.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB (HBM3), the data sheet's memory bandwidth, at the
# card's full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12


def picture_bytes(width: int, height: int, kind: str) -> int:
    """Bytes that one decoded picture of display size width x height and
    slice type `kind` ("I", "P" or "B") needs moved, at the least."""
    if kind not in ("I", "P", "B"):
        raise ValueError(f"picture kind {kind!r}")
    planes = width * height * 3 // 2
    reference = planes if kind in ("P", "B") else 0
    return planes + reference


def roofline_pct(nbytes: int, kernel_s: float) -> float | None:
    """Share of the byte roofline: the least time for `nbytes` at the
    peak, over the kernels' time; None when no kernel time was read."""
    if not kernel_s > 0:
        return None
    return 100.0 * nbytes / PEAK_BYTES_PER_S / kernel_s
