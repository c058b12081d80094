"""Fuzz the port's copy of the C++ slice parser (host/cpp/, the library
that parses untrusted bytes on the card's host).

The port's counterpart of tests/test_cpp_fuzz.py: the same seeded corpus
of mutated conformance streams (bit flips, truncations, duplicated and
spliced slice NALs; SPS/PPS stay intact so that the picture geometry,
and with it every allocation, stays sane) goes through the port's host
half: the C++ parse, the reference bookkeeping and colocated-motion scan
of the DPB commit, the ABI pack and the wire pack (pack_wire_raw and
emit_wire, whose scans are C calls too).  Every case must parse or raise
a clean Python exception, and both outcomes must occur.  Each run is a
subprocess, so that a crash fails the test and not the pytest worker.

test_port_fuzz_asan runs the 300 cases through the ASAN/UBSAN build (any
out-of-bounds access aborts) and is `slow`, as the JAX package's is;
test_port_fuzz runs them through the normal build, where they take
seconds (a crash still fails it).  Of the corpus's first 30 cases none
parses, so a shorter fast run would see one outcome only.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
ASAN_OPTIONS = ("detect_leaks=0:detect_odr_violation=0:"
                "detect_container_overflow=0")
N_CASES = 300


def _nal_spans(data: bytes) -> list:
    """Byte spans of the slice NAL payloads (start codes excluded)."""
    spans, starts, i = [], [], 0
    while True:
        j = data.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        starts.append(j + 3)
        i = j + 3
    for s in starts:
        e = data.find(b"\x00\x00\x01", s)
        e = len(data) if e < 0 else (e - 1 if data[e - 1:e] == b"\x00" else e)
        if data[s] & 0x1F in (1, 5):
            spans.append((s, e))
    return spans


def mutate(data: bytes, rng) -> bytes:
    """One mutation of a slice NAL, as tests/test_cpp_fuzz.py makes it."""
    spans = _nal_spans(data)
    b = bytearray(data)
    kind = rng.integers(0, 4)
    if not spans:
        return bytes(b)
    s, e = spans[rng.integers(0, len(spans))]
    if kind == 0:      # random bit flips inside one slice NAL
        for _ in range(int(rng.integers(1, 12))):
            p = int(rng.integers(s, e))
            b[p] ^= 1 << int(rng.integers(0, 8))
    elif kind == 1:    # truncate mid-slice
        del b[int(rng.integers(s + 1, e)):]
    elif kind == 2:    # duplicate a slice NAL (start code included)
        chunk = bytes(b[s - 3:e])
        p = int(rng.integers(s, len(b)))
        b[p:p] = chunk
    else:              # splice random bytes into the slice payload
        p = int(rng.integers(s, e))
        b[p:p] = bytes(rng.integers(0, 256, int(rng.integers(1, 64)),
                                    dtype=np.uint8))
    return bytes(b)


def fuzz(paths: list, n_cases: int) -> None:
    """Run the first n_cases mutations of the base streams at `paths`
    through the port's host half; prints "FUZZ-OK <parsed> <rejected>"."""
    import torch

    from arrow_h264_tpu_torch.api import Decoder
    from arrow_h264_tpu_torch.ops.wire import emit_wire, pack_wire_raw

    bases = [Path(p).read_bytes() for p in paths]
    rng = np.random.default_rng(1234)
    n_ok = n_err = 0
    for case in range(n_cases):
        data = mutate(bases[case % len(bases)], rng)
        try:
            dec = Decoder(device="cpu")
            if dec.entropy != "cpp":
                raise SystemExit("the C++ entropy library did not load")
            for pic, poc in dec.parse_pictures(data):
                mb_w = pic.sps.pic_width_in_mbs
                mb_h = pic.sps.pic_height_in_map_units
                abi = dec.pack_abi(pic, poc)
                raw, spec = pack_wire_raw(abi, mb_w, mb_h)
                emit_wire(raw, spec, spec, mb_w * mb_h)
                H, W = mb_h * 16, mb_w * 16
                y, cb, cr = (torch.zeros(s, dtype=torch.uint8) for s in
                             ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
                n_slots = max(2, min(pic.sps.max_num_ref_frames, 32) + 1)
                # drop the views into the parse buffers, so that the pool
                # recycles them (h264e_reset_pic's recycled path)
                del abi, raw
                list(dec.commit(pic, poc, y, cb, cr, n_slots,
                                lambda *a: None))
                pic.retire()
            n_ok += 1
        except Exception:
            n_err += 1
    print("FUZZ-OK", n_ok, n_err)


@pytest.fixture(scope="module")
def bases(h264ref, tmp_path_factory):
    """The corpus's two base streams, as tests/test_cpp_fuzz.py makes
    them: CABAC with B-frames and CAVLC P-only, 64x64, 4 frames."""
    from tools import streams
    d = tmp_path_factory.mktemp("fuzz")
    paths = []
    for name, cfg in (("cabac", 3), ("cavlc", 2)):
        path = str(d / f"fuzz_base_{name}.264")
        streams.encode(streams.make_content(64, 64, 4, seed=11), 64, 64,
                       path, streams.CONFIG_OPTS[cfg])
        paths.append(path)
    return paths


def _run(paths: list, n_cases: int, sanitize: bool, timeout: int):
    """The fuzz in a subprocess; returns (parsed, rejected)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "ARROW_H264_"))}
    env["PYTHONPATH"] = str(REPO)
    if sanitize:
        env["LD_PRELOAD"] = subprocess.run(
            ["g++", "-print-file-name=libasan.so"], capture_output=True,
            text=True, check=True).stdout.strip()
        env["ARROW_H264_SANITIZE"] = "1"
        env["ASAN_OPTIONS"] = ASAN_OPTIONS
    code = (f"from tests.test_torch_fuzz import fuzz; "
            f"fuzz({paths!r}, {n_cases})")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0 and "FUZZ-OK" in r.stdout, \
        (r.returncode, r.stdout[-2000:], r.stderr[-4000:])
    assert "Sanitizer" not in r.stderr and "runtime error" not in r.stderr, \
        r.stderr[-4000:]
    ok, err = map(int, r.stdout.split("FUZZ-OK")[1].split())
    assert ok + err == n_cases
    # both outcomes: mutations that still parse and mutations rejected
    # cleanly, or the corpus exercises nothing
    assert ok > 0 and err > 0, (ok, err)
    return ok, err


def test_port_fuzz(bases):
    """The 300 mutations through the normal build."""
    _run(bases, N_CASES, sanitize=False, timeout=600)


@pytest.mark.slow
def test_port_fuzz_asan(bases):
    """The 300 mutations through the ASAN/UBSAN build."""
    _run(bases, N_CASES, sanitize=True, timeout=1800)
