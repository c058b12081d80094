"""The bench's device_wildmv inputs (arrow_h264_tpu_torch.bench) against
the JAX package on the CPU, at mb 8 x 6 and B = 2: the synthetic ABIs
with 5 % of cells given MVs in +-512 quarter samples, as the JAX
package's bench.py builds them for device_patch_fps, decoded by the
port's decode_frames_batch_fn and by the JAX package's with the
inter_mode and patch list its select_inter_mode picks (default backend:
the XLA gather MC), over DPBs stored from the same numpy reference
pictures.  The JAX package's TPU MC kernels with that patch list
(`_mc_pred_batch`, Pallas in interpret mode) are held against the port's
MC on every predicted cell.  The host half that host_parse_fps and the e2e
stages time on the --streams broadcast and adversarial sets: the first 3
pictures of bench_broadcast_s0 and bench_adversarial through the port's
Decoder(device="cpu", entropy="cpp").pack_abi and the JAX package's
Decoder(entropy="cpp").pack_abi, key by key.  atol 0 throughout."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_h264_tpu_torch import bench, convert
from arrow_h264_tpu_torch.api import Decoder
from arrow_h264_tpu_torch.models import pipeline
from arrow_h264_tpu_torch.ops.abi import KIND_P

MB_W, MB_H, B = 8, 6, 2


@pytest.fixture(scope="module")
def jax_side():
    """(host ABIs with `patch`, inter_mode, slot lists, JAX packed DPBs
    (y, c) stacked over lanes, JAX output planes)."""
    from arrow_h264_tpu.models.pipeline import (
        ABI_DEVICE_KEYS, decode_frames_batch_fn, dpb_alloc,
        select_inter_mode, store_ref_fn,
    )
    from arrow_h264_tpu.ops.synthetic import synthetic_abi_p
    from arrow_h264_tpu.ops.transforms import make_ws_consts
    hosts, rows, modes = [], [], set()
    for i in range(B):
        # bench.py's device_patch_fps inputs
        abi = synthetic_abi_p(MB_W, MB_H, seed=50 + i, n_slots=2)
        rng = np.random.default_rng(77 + i)
        n = MB_W * MB_H
        wild = rng.random((n, 4, 4)) < 0.05
        wmv = rng.integers(-512, 512, (n, 4, 4, 2, 2)).astype(np.int32)
        abi["mv"] = np.where(wild[..., None, None], wmv, abi["mv"])
        mode, sl, patch = select_inter_mode(abi, MB_W, MB_H)
        abi["patch"] = patch
        hosts.append(abi)
        rows.append(sl)
        modes.add(mode)
    assert len(modes) == 1
    mode = modes.pop()
    assert mode.endswith("p"), mode          # the patch path engages
    y, cb, cr = bench.reference_planes(B, MB_W, MB_H)
    store = jax.jit(store_ref_fn, static_argnums=2)
    dpbs = []
    for i in range(B):
        dpb = dpb_alloc(MB_W, MB_H, bench.N_SLOTS)
        for s in range(bench.N_SLOTS):
            dpb = store(*dpb, s, jnp.asarray(y[i, s]),
                        jnp.asarray(cb[i, s]), jnp.asarray(cr[i, s]))
        dpbs.append(dpb)
    dpb_y = jnp.stack([d[0] for d in dpbs])
    dpb_c = jnp.stack([d[1] for d in dpbs])
    ws4, ws8 = make_ws_consts([[16] * 16] * 6, [[16] * 64] * 2)
    abi_b = {k: jnp.asarray(np.stack([h[k] for h in hosts]))
             for k in ABI_DEVICE_KEYS}
    slots = jnp.asarray(np.stack(rows))
    fn = jax.jit(functools.partial(
        decode_frames_batch_fn, mb_w=MB_W, mb_h=MB_H, cqp_off=(0, 0),
        n_streams=B, inter_mode=mode))
    out = fn(abi_b, dpb_y, dpb_c, slots, ws4=jnp.asarray(ws4),
             ws8=jnp.asarray(ws8))
    return dict(hosts=hosts, mode=mode, abi_b=abi_b, slots=slots,
                dpb=(np.asarray(dpb_y), np.asarray(dpb_c)),
                out=[np.asarray(p) for p in out])


def _port_dpb(jax_side):
    """The JAX DPBs carried over with convert.dpb_from_jax, [B, S, ...]."""
    dy, dc = jax_side["dpb"]
    lanes = [convert.dpb_from_jax(dy[i], dc[i], MB_W, MB_H)
             for i in range(B)]
    return (torch.stack([d[0] for d in lanes]),
            torch.stack([d[1] for d in lanes]))


def test_inputs_equal_jax_package(jax_side):
    """bench.synthetic_lanes("wildmv") is the JAX package's bench input,
    and bench.reference_dpb stores the DPB the JAX package stores."""
    port = bench.synthetic_lanes("wildmv", B, MB_W, MB_H)
    for a, j in zip(port, jax_side["hosts"]):
        for k in pipeline.ABI_DEVICE_KEYS:
            assert np.array_equal(a[k], j[k]), k
    dy, dc = bench.reference_dpb(bench.reference_planes(B, MB_W, MB_H),
                                 MB_W, MB_H, "cpu")
    want_y, want_c = _port_dpb(jax_side)
    assert torch.equal(dy, want_y) and torch.equal(dc, want_c)


@pytest.mark.parametrize("order", ["phase", "raster"])
def test_wildmv_decode_equals_jax(jax_side, order):
    """The port's decode_frames_batch_fn on the bench's wild-MV lanes ==
    the JAX package's, all three planes."""
    import arrow_h264_tpu_torch.ops.transforms as tr
    lanes = bench.synthetic_lanes("wildmv", B, MB_W, MB_H)
    abi = pipeline.upload_batch(lanes, "cpu")
    dy, dc = _port_dpb(jax_side)
    ws4, ws8 = tr.make_ws_consts([[16] * 16] * 6, [[16] * 64] * 2)
    got = pipeline.decode_frames_batch_fn(
        abi, dy, dc, mb_w=MB_W, mb_h=MB_H, ws4=ws4, ws8=ws8,
        cqp_off=(0, 0), inter=True, order=order)
    for g, w, name in zip(got, jax_side["out"], ("y", "cb", "cr")):
        assert np.array_equal(g.numpy(), w), name


def test_wildmv_mc_equals_jax_pallas_patch(jax_side):
    """The JAX package's TPU MC kernels with its patch repair
    (`_mc_pred_batch`, interpret mode) == the port's MC (K3/K4's plain
    versions + K10's, inter_init_plain, over zero residual planes) on
    every cell that predicts."""
    from arrow_h264_tpu.models.pipeline import _mc_pred_batch
    dy, dc = jax_side["dpb"]
    mc = jax.jit(functools.partial(_mc_pred_batch, mb_w=MB_W, mb_h=MB_H,
                                   inter_mode=jax_side["mode"]))
    want = mc(jax_side["abi_b"], jnp.asarray(dy), jnp.asarray(dc),
              jax_side["slots"])
    lanes = bench.synthetic_lanes("wildmv", B, MB_W, MB_H)
    abi = pipeline.upload_batch(lanes, "cpu")
    H, W = 16 * MB_H, 16 * MB_W
    zeros = (torch.zeros((B, H, W), dtype=torch.int32),
             *(torch.zeros((B, H // 2, W // 2), dtype=torch.int32)
               for _ in "cc"))
    got = pipeline._mc_pred(abi, *_port_dpb(jax_side), zeros, MB_W, MB_H)
    used = np.stack([(a["refslot"] >= 0).any(-1) & (a["kind"] >= KIND_P)
                     [:, None, None] for a in lanes])      # [B, n, 4, 4]
    m = used.reshape(B, MB_H, MB_W, 4, 4).transpose(0, 1, 3, 2, 4) \
        .reshape(B, MB_H * 4, MB_W * 4)
    for g, w, s, name in zip(got, want, (4, 2, 2), ("y", "cb", "cr")):
        msk = np.repeat(np.repeat(m, s, 1), s, 2)
        assert msk.any()
        bad = (g.numpy() != np.asarray(w)) & msk
        assert not bad.any(), (name, np.argwhere(bad)[:4])


def _pack_abis(dec, data: bytes, zeros) -> list[dict]:
    """Each picture's pack_abi (public fields), committed to the DPB with
    zero planes (zeros(shape)) and no device store, as the bench's host
    stages do."""
    abis = []
    for pic, poc in dec.parse_pictures(data):
        abis.append({k: np.array(v) if isinstance(v, np.ndarray) else v
                     for k, v in dec.pack_abi(pic, poc).items()
                     if not k.startswith("_")})
        H, W = pic.mb_h * 16, pic.mb_w * 16
        planes = (zeros((H, W)), *(zeros((H // 2, W // 2)) for _ in "cc"))
        list(dec.commit(pic, poc, *planes, pipeline.dpb_slots(pic.sps),
                        lambda *a: None))
    return abis


@pytest.mark.parametrize("name", ["bench_broadcast_s0", "bench_adversarial"])
def test_bench_stream_abis_equal_jax(name):
    """The first 3 pictures (an I, a P and a P or B) of the broadcast and
    adversarial sets pack to the JAX package's ABIs, key by key, atol 0."""
    from arrow_h264_tpu.api import Decoder as JaxDecoder
    data = bench.truncate_aus((bench.DATA / f"{name}.264").read_bytes(), 3)
    port, ref = Decoder(device="cpu", entropy="cpp"), JaxDecoder(entropy="cpp")
    assert port.entropy == ref.entropy == "cpp"
    got = _pack_abis(port, data, lambda s: torch.zeros(s, dtype=torch.uint8))
    want = _pack_abis(ref, data, lambda s: np.zeros(s, np.uint8))
    assert len(got) == len(want) == 3
    assert (want[1]["kind"] >= KIND_P).any()
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (i, set(g) ^ set(w))
        for k in w:
            assert np.array_equal(g[k], w[k]), f"picture {i}: field {k}"
