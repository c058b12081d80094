"""Shared helpers of the port's tests (tests/test_torch_*.py): the same
inputs, made with numpy from a seed or parsed from real streams, go through
the JAX package and through the PyTorch port.  All values are integers and
every comparison is exact (atol 0)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from arrow_h264_tpu.api import Decoder as JaxDecoder
from arrow_h264_tpu.ops import deblock as jdeblock
from arrow_h264_tpu.ops import intra as jintra
from arrow_h264_tpu.ops import transforms as jtransforms
from arrow_h264_tpu_torch.api import Decoder
from arrow_h264_tpu_torch.models import pipeline as tpipeline
from tools import streams

QCIF = (176, 144)
FLAT4, FLAT8 = [[16] * 16] * 6, [[16] * 64] * 2


def host_arrays(abi) -> dict:
    """The numpy arrays of a FrameABI (drops ints and private hints)."""
    return {k: np.asarray(v) for k, v in abi.items()
            if isinstance(v, np.ndarray) and not k.startswith("_")}


# the ABI fields each JAX reference reads: one fixed pytree per function,
# so that its jit compiles once per test process
INTRA_KEYS = ("kind", "i4_modes", "i4_avail", "i8_modes", "i8_avail",
              "i16_mode", "chroma_mode", "mb_avail")
DEBLOCK_KEYS = ("kind", "nz", "mv", "refid", "qp", "slice_id", "disable_idc",
                "alpha_off", "beta_off", "tr8")


def to_jax(abi, keys=None) -> dict:
    arrs = host_arrays(abi)
    return {k: jnp.asarray(arrs[k]) for k in (keys or arrs)}


def to_torch(abi, batch: bool = True) -> dict:
    """Host ABI -> int32 CPU tensors, with a stream axis B = 1 if batch."""
    out = {}
    for k, v in host_arrays(abi).items():
        t = torch.from_numpy(np.ascontiguousarray(v, np.int32))
        out[k] = t[None] if batch else t
    return out


def assert_same(port, ref, what: str = "") -> None:
    """Exact equality of a port tensor and a reference array."""
    p = np.asarray(port.cpu().numpy() if isinstance(port, torch.Tensor)
                   else port)
    r = np.asarray(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    if not np.array_equal(p.astype(np.int64), r.astype(np.int64)):
        bad = np.argwhere(p != r)
        i = tuple(bad[0])
        raise AssertionError(f"{what}: {len(bad)} values differ; first at "
                             f"{i}: port {p[i]} vs reference {r[i]}")


@functools.lru_cache(maxsize=None)
def jax_residual(mb_w, mb_h, keys, cqp_off=(0, 0), bypass=False):
    """Jitted JAX residual_planes for one ABI key set (static shapes)."""
    return jax.jit(lambda abi, ws4, ws8: jtransforms.residual_planes(
        abi, mb_w, mb_h, ws4, ws8, cqp_off, bypass=bypass))


@functools.lru_cache(maxsize=None)
def jax_intra(mb_w, mb_h):
    """Jitted JAX intra_reconstruct; takes to_jax(abi, INTRA_KEYS)."""
    return jax.jit(lambda abi, ry, rcb, rcr, iy, icb, icr:
                   jintra.intra_reconstruct(abi, ry, rcb, rcr, mb_w, mb_h,
                                            iy, icb, icr))


@functools.lru_cache(maxsize=None)
def jax_deblock(mb_w, mb_h):
    """Jitted JAX (deblock_planes, deblock_tables); they take
    to_jax(abi, DEBLOCK_KEYS) and the chroma QP offsets as an int32 [2]
    array, traced so that one compile serves every stream."""
    planes = jax.jit(lambda abi, y, cb, cr, cqp: jdeblock.deblock_planes(
        abi, y, cb, cr, mb_w, mb_h, (cqp[0], cqp[1])))
    tables = jax.jit(lambda abi, cqp: jdeblock.deblock_tables(
        abi, mb_w, mb_h, (cqp[0], cqp[1])))
    return planes, tables


def stream_consts(pipe):
    """(ws4, ws8, cqp_off) of a port DevicePipeline's SPS/PPS, with the
    JAX package's make_ws_consts (numpy)."""
    sps, pps = pipe.sps, pipe.pps
    sl4 = pps.scaling_lists_4x4 if pps.scaling_lists_4x4 is not None \
        else sps.scaling_lists_4x4
    sl8 = pps.scaling_lists_8x8 if pps.scaling_lists_8x8 is not None \
        else sps.scaling_lists_8x8
    ws4, ws8 = jtransforms.make_ws_consts(sl4, sl8)
    return ws4, ws8, (pps.chroma_qp_index_offset, pps.chroma_qp_offset(1))


def encode(tmp_path, cfg, n_frames: int = 3, seed: int = 7,
           size=QCIF) -> str:
    w, h = size
    path = str(tmp_path / f"cfg{cfg}_{w}x{h}_s{seed}.264")
    streams.encode(streams.make_content(w, h, n_frames, seed=seed), w, h,
                   path, streams.CONFIG_OPTS[cfg])
    return path


def decode_port(path: str, capture: list | None = None,
                order: str = "phase") -> np.ndarray:
    """Decode with the port on the CPU -> [frames, bytes] uint8.  With
    `capture`, append (host ABI copy, pipeline) for each decoded picture,
    the DPB as it was before that picture was stored."""
    dec = Decoder(device="cpu", order=order)
    if capture is not None:
        orig = tpipeline.DevicePipeline.decode_frame

        def spy(self, abi):
            capture.append(({k: (v.copy() if isinstance(v, np.ndarray)
                                 else v) for k, v in abi.items()},
                            self, self.dpb_y.clone(), self.dpb_c.clone()))
            return orig(self, abi)

        tpipeline.DevicePipeline.decode_frame = spy
    try:
        frames = [np.frombuffer(f.planar(), np.uint8)
                  for f in dec.decode_annexb(open(path, "rb").read())]
    finally:
        if capture is not None:
            tpipeline.DevicePipeline.decode_frame = orig
    return np.stack(frames)


def decode_jax(path: str) -> np.ndarray:
    """Decode with the JAX package's Decoder -> [frames, bytes] uint8."""
    return np.stack([np.frombuffer(f.planar(), np.uint8)
                     for f in JaxDecoder().decode_annexb(
                         open(path, "rb").read())])
