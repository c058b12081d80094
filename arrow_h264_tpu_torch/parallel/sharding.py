"""Multi-device stream sharding: a lockstep round split over devices.

Port of `arrow_h264_tpu.parallel.sharding`.  Decoding is data parallel
over independent streams, so a round's batch of B lanes splits into
len(mesh) contiguous shards of B / len(mesh) lanes, and each shard runs
the whole pipeline (`decode_frames_batch_fn`, then `store_refs_fn`) on its
own device.  No collectives: each shard's DPB, constants, ABI upload and
planes stay on its device.

A mesh is a tuple of torch devices, one per shard; a device may appear
more than once (several shards on one card).  Each shard's work is queued
on its device's current stream, so shards that share a card run one
after another, never side by side: the persistent wavefront kernels must
not share a card with another launch of themselves.
"""

from __future__ import annotations

import torch

from ..models.pipeline import decode_frames_batch_fn, store_refs_fn


def make_stream_mesh(devices=None) -> tuple:
    """The mesh of `devices` (default: every visible CUDA device)."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("make_stream_mesh: no devices")
    return mesh


def shard_bounds(mesh, n_streams: int) -> list[tuple[int, int]]:
    """[(first lane, end lane)] of each shard of an n_streams batch."""
    k = len(mesh)
    if k == 0 or n_streams % k:
        raise ValueError(f"{n_streams} streams do not split evenly over "
                         f"{k} devices")
    per = n_streams // k
    return [(s * per, (s + 1) * per) for s in range(k)]


def sharded_decode_fn(mesh, n_streams: int, **consts):
    """The lockstep reconstruction step over `mesh`: a function of
    (abis, dpb_y, dpb_c, inter) -> [(y, cb, cr) of each shard].

    consts: decode_frames_batch_fn's keyword arguments other than `inter`
    (models.pipeline.decode_consts), copied once to each device.  abis,
    dpb_y, dpb_c: one entry per shard, its lanes' ABI tensors [B/k, ...]
    and DPBs [B/k, S, ...] on the shard's device.  inter: whether any
    lane of the round is inter; every shard then runs MC.  Each shard's
    planes stay on its device."""
    shard_bounds(mesh, n_streams)
    per_dev = {dev: {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                     for k, v in consts.items()} for dev in set(mesh)}

    def step(abis, dpb_y, dpb_c, inter: bool):
        if not len(abis) == len(dpb_y) == len(dpb_c) == len(mesh):
            raise ValueError(f"{len(abis)} ABI, {len(dpb_y)} and "
                             f"{len(dpb_c)} DPB shards for a mesh of "
                             f"{len(mesh)}")
        return [decode_frames_batch_fn(a, y, c, inter=inter, **per_dev[dev])
                for dev, a, y, c in zip(mesh, abis, dpb_y, dpb_c)]

    return step


def sharded_store_fn(mesh, n_streams: int):
    """The batch's reference store over `mesh`: a function of (dpb_y,
    dpb_c, lanes, slots, planes) that writes lane lanes[j]'s picture into
    slot slots[j] of its DPB row, in place, one store_refs_fn a shard.
    dpb_y, dpb_c: the shards' DPBs [B/k, S, ...]; planes: the shards'
    (y, cb, cr) as sharded_decode_fn returns them; lanes index the whole
    batch."""
    bounds = shard_bounds(mesh, n_streams)

    def store(dpb_y, dpb_c, lanes, slots, planes) -> None:
        for (s0, s1), y, c, p in zip(bounds, dpb_y, dpb_c, planes):
            mine = [j for j, i in enumerate(lanes) if s0 <= i < s1]
            store_refs_fn(y, c, [lanes[j] - s0 for j in mine],
                          [slots[j] for j in mine], *p)

    return store
