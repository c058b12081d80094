"""The port's stream sharding (arrow_h264_tpu_torch.parallel.sharding) on
the CPU: the sharded lockstep step over 1, 2, 4 and 8 shards equal to the
JAX package's sharded step on its 8-device CPU mesh; a sharded
BatchDecoder equal to the unsharded one and to the goldens, with a
corrupt lane failing alone; uneven splits refused.  Every comparison is
exact."""

import functools
import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_h264_tpu_torch import convert
from arrow_h264_tpu_torch.models.pipeline import dpb_alloc, store_refs_fn
from arrow_h264_tpu_torch.parallel.batch import (
    BatchDecoder, decode_batch_lockstep,
)
from arrow_h264_tpu_torch.parallel.sharding import (
    make_stream_mesh, shard_bounds, sharded_decode_fn, sharded_store_fn,
)
from tests.torch_ref import FLAT4, FLAT8

DATA = Path(__file__).resolve().parent / "data"
# QCIF config-4 lanes of 3, 4, 5 and 3 frames (tools/smoke_stream.py)
QCIF_LANES = [DATA / f"batch_qcif_s{i}.264" for i in range(1, 5)]
N = 8
MB_W, MB_H = 2, 2


@functools.lru_cache(maxsize=None)
def _jax_step():
    """(abis, JAX DPBs as numpy, ws4, ws8, the JAX sharded step's planes)
    of tests/test_batch_multichip.py:103: eight synthetic P lanes over
    the 8-device CPU mesh."""
    from arrow_h264_tpu.models import pipeline as jpipeline
    from arrow_h264_tpu.ops.synthetic import synthetic_abi_p
    from arrow_h264_tpu.ops.transforms import make_ws_consts
    from arrow_h264_tpu.parallel.batch import (
        decode_batch_lockstep as jax_lockstep,
    )
    from arrow_h264_tpu.parallel.sharding import (
        make_stream_mesh as jax_mesh, sharded_decode_fn as jax_sharded,
    )
    assert len(jax.devices()) == N, "conftest should provide 8 cpu devices"
    H, W = MB_H * 16, MB_W * 16
    mesh = jax_mesh()
    ws4, ws8 = make_ws_consts(FLAT4, FLAT8)
    abis = [synthetic_abi_p(MB_W, MB_H, seed=i, n_mv=6) for i in range(N)]
    rng = np.random.default_rng(5)
    jdpbs = []
    for _ in range(N):
        dpb = jpipeline.dpb_alloc(MB_W, MB_H, 2)
        for s in range(2):
            dpb = jpipeline.store_ref_fn(*dpb, s, *(
                jnp.asarray(rng.integers(0, 256, shape, np.uint8))
                for shape in ((H, W), (H // 2, W // 2), (H // 2, W // 2))))
        jdpbs.append(tuple(np.asarray(p) for p in dpb))
    fn = jax_sharded(mesh, MB_W, MB_H, ws4, ws8, inter_mode="pl0")
    want = jax_lockstep(fn, abis, [tuple(map(jnp.asarray, d))
                                   for d in jdpbs],
                        [np.array([0, 1, -1, -1], np.int32)] * N, mesh)
    return abis, jdpbs, ws4, ws8, tuple(np.asarray(w) for w in want)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_sharded_step_matches_jax(k):
    """decode_batch_lockstep over mesh=("cpu",)*k equals the JAX sharded
    step, with the JAX DPBs carried over."""
    abis, jdpbs, ws4, ws8, want = _jax_step()
    dpbs = [convert.dpb_from_jax(y, c, MB_W, MB_H) for y, c in jdpbs]
    tws4, tws8 = convert.ws_from_jax(ws4, ws8)
    got = decode_batch_lockstep(abis, dpbs, mesh=("cpu",) * k, mb_w=MB_W,
                                mb_h=MB_H, ws4=tws4, ws8=tws8,
                                cqp_off=(0, 0))
    for p, w in zip(got, want):
        assert p.shape[0] == N
        assert np.array_equal(p.numpy(), w[:, :p.shape[1]])


def test_sharded_store_matches_store_refs_fn():
    """The sharded store writes each storing lane's slot of its shard's
    DPB as one store_refs_fn over the whole batch does, lane indices
    local to the shard."""
    B, S = 4, 3
    H, W = MB_H * 16, MB_W * 16
    g = torch.Generator().manual_seed(3)
    dy, dc = (t.view((B, S) + t.shape[1:])
              for t in dpb_alloc(MB_W, MB_H, B * S, "cpu"))
    dy.copy_(torch.randint(0, 256, dy.shape, generator=g, dtype=torch.uint8))
    dc.copy_(torch.randint(0, 256, dc.shape, generator=g, dtype=torch.uint8))
    planes = [torch.randint(0, 256, s, generator=g, dtype=torch.uint8)
              for s in ((B, H, W), (B, H // 2, W // 2), (B, H // 2, W // 2))]
    lanes, slots = [3, 0, 2], [1, 2, 0]
    mesh = make_stream_mesh(["cpu", "cpu"])
    bounds = shard_bounds(mesh, B)
    assert bounds == [(0, 2), (2, 4)]
    sy = [dy[s0:s1].clone() for s0, s1 in bounds]
    sc = [dc[s0:s1].clone() for s0, s1 in bounds]
    sharded_store_fn(mesh, B)(sy, sc, lanes, slots,
                              [tuple(p[s0:s1] for p in planes)
                               for s0, s1 in bounds])
    store_refs_fn(dy, dc, lanes, slots, *planes)
    assert torch.equal(torch.cat(sy), dy) and torch.equal(torch.cat(sc), dc)


def _md5s(frames) -> list[str]:
    return [hashlib.md5(f.planar()).hexdigest() for f in frames]


@functools.lru_cache(maxsize=None)
def _qcif(mesh, corrupt=None):
    """(md5s of each lane, errors, rounds, wire rounds, dense rounds, the
    decoder's mesh) of BatchDecoder(4) over the QCIF lanes."""
    datas = [p.read_bytes() for p in QCIF_LANES]
    if corrupt is not None:
        d = datas[corrupt]
        datas[corrupt] = d[:len(d) // 2] + b"\x00\x17" * 40
    with BatchDecoder(len(datas), device="cpu", mesh=mesh) as bd:
        outs = bd.decode(datas)
    return ([_md5s(o) for o in outs], bd.errors, bd.rounds, bd.wire_rounds,
            bd.dense_rounds, bd.mesh)


def _golden() -> list[list[str]]:
    return [json.loads(p.with_suffix(".json").read_text())["md5"]
            for p in QCIF_LANES]


@pytest.mark.parametrize("mesh", [("cpu",), ("cpu", "cpu")])
def test_sharded_batch_decoder(mesh):
    """BatchDecoder(4) with 1 and 2 shards: every lane equal to its
    golden MD5s (so to one another), every round through the wire."""
    md5s, errors, rounds, wire_rounds, dense_rounds, got_mesh = _qcif(mesh)
    assert got_mesh == tuple(torch.device(d) for d in mesh)
    assert errors == [None] * 4
    assert md5s == _golden()
    assert (rounds, wire_rounds, dense_rounds) == (5, 5, 0)


def test_sharded_batch_decoder_corrupt_lane():
    """A corrupt lane in shard 1 of 2 fails alone; every other lane,
    its shard partner included, stays equal to its golden."""
    bad = 3
    md5s, errors, *_ = _qcif(("cpu", "cpu"), bad)
    assert errors[bad] is not None
    gold = _golden()
    for i in range(4):
        if i != bad:
            assert errors[i] is None, (i, errors[i])
            assert md5s[i] == gold[i], i


def test_uneven_split_refused():
    """A batch that does not split evenly over the mesh raises."""
    with pytest.raises(ValueError, match="split evenly"):
        BatchDecoder(3, device="cpu", mesh=("cpu", "cpu"))
    with pytest.raises(ValueError, match="split evenly"):
        sharded_decode_fn(("cpu",) * 2, 3)
    with pytest.raises(ValueError, match="split evenly"):
        sharded_store_fn(("cpu",) * 4, 6)
    with BatchDecoder(3, device="cpu") as bd:
        assert bd.mesh == (torch.device("cpu"),)
