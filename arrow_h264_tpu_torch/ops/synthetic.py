"""Synthetic frame ABIs for kernel checks and timing.

`synthetic_batch` uploads the JAX package's numpy ABIs
(`arrow_h264_tpu.ops.synthetic`): a random I frame, or a P/B frame with a
bounded MV palette and sparse intra MBs.  `random_intra_abi` draws the
intra fields with no structure at all.
"""

from __future__ import annotations

import numpy as np

from arrow_h264_tpu.ops.synthetic import synthetic_abi, synthetic_abi_p

from ..models.pipeline import upload_abi


def synthetic_batch(mb_w: int, mb_h: int, seed: int, device,
                    inter: bool = False, **kw) -> tuple[dict, dict]:
    """(host FrameABI, device ABI dict with a leading stream axis B = 1)."""
    abi = synthetic_abi_p(mb_w, mb_h, seed, **kw) if inter else \
        synthetic_abi(mb_w, mb_h, seed, **kw)
    return abi, {k: v[None] for k, v in upload_abi(abi, device).items()}


def random_intra_abi(mb_w: int, mb_h: int, seed: int) -> dict:
    """Intra ABI fields (numpy int32) with every kind, random modes and
    random availability bits, so reads at the picture border happen too
    (they read 0).  PCM MBs need raw samples (0..255) as residual."""
    rng = np.random.default_rng(seed)
    n = mb_w * mb_h
    return dict(
        kind=rng.choice([0, 1, 2, 3, 4], n, p=[.3, .25, .2, .05, .2])
        .astype(np.int32),
        i4_modes=rng.integers(0, 9, (n, 16)).astype(np.int32),
        i4_avail=rng.integers(0, 2, (n, 16, 4)).astype(np.int32),
        i8_modes=rng.integers(0, 9, (n, 4)).astype(np.int32),
        i8_avail=rng.integers(0, 2, (n, 4, 4)).astype(np.int32),
        i16_mode=rng.integers(0, 4, n).astype(np.int32),
        chroma_mode=rng.integers(0, 4, n).astype(np.int32),
        mb_avail=rng.integers(0, 2, (n, 3)).astype(np.int32))
