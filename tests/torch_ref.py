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

# The suite runs in six pytest-xdist workers on one host, and torch's
# default of one intra-op thread per core makes them oversubscribe it: six
# concurrent CPU decodes of a 1080p stream took 463 s each with 8 threads
# and 15 s with 2 (an 8-core host).  The port's test modules that decode
# import this one, so that their worker keeps to 2 threads.
torch.set_num_threads(min(2, torch.get_num_threads()))

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


def _copy_abi(abi) -> dict:
    """A copy of a host ABI whose arrays (and dicts of arrays, such as the
    row hints) own their memory."""
    def cp(v):
        if isinstance(v, np.ndarray):
            return v.copy()
        if isinstance(v, dict):
            return {k: cp(x) for k, x in v.items()}
        return v
    return {k: cp(v) for k, v in abi.items()}


def decode_port(path: str, capture: list | None = None,
                order: str = "phase", conceal: bool = False) -> np.ndarray:
    """Decode with the port on the CPU -> [frames, bytes] uint8.  With
    `capture`, append (host ABI copy, pipeline) for each decoded picture,
    the DPB as it was before that picture was stored."""
    dec = Decoder(device="cpu", order=order, conceal=conceal)
    if capture is not None:
        orig = tpipeline.DevicePipeline.decode_frame

        def spy(self, abi):
            capture.append((_copy_abi(abi), self, self.dpb_y.clone(),
                            self.dpb_c.clone()))
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


def strip_case(tmp_path, cfg: int, size, n_frames: int) -> tuple:
    """(path, golden, JAX Decoder's frames) of a config-`cfg` stream of
    `n_frames` at `size` (seed 40 + cfg, as tools/tpu_conformance.py)."""
    path = encode(tmp_path, cfg, n_frames=n_frames, seed=40 + cfg, size=size)
    golden, w, h = streams.golden_decode(path)
    assert (w, h, len(golden)) == (*size, n_frames)
    return path, golden, decode_jax(path)


def check_strip(case: tuple, order: str | None) -> None:
    """The JAX decode of a strip_case equals its golden (order None), or
    the port's with `order` equals both, frame by frame."""
    path, golden, jax_out = case
    ours = jax_out if order is None else decode_port(path, order=order)
    for f in range(len(golden)):
        assert np.array_equal(ours[f], golden[f]), \
            f"frame {f}: {int((ours[f] != golden[f]).sum())} byte diffs"
    assert np.array_equal(ours, jax_out)
