"""The port's own host half (bitstream, entropy, DPB, ABI packing, the C++
entropy library) against the JAX package's, from which it was copied:
the same streams give the same frame ABIs, POCs and output order."""

import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from arrow_h264_tpu.api import Decoder as JaxDecoder
from arrow_h264_tpu.ops import synthetic as jsynthetic
from arrow_h264_tpu_torch.api import Decoder
from arrow_h264_tpu_torch.host import centropy
from arrow_h264_tpu_torch.ops import synthetic as tsynthetic
from tests.torch_ref import encode

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "arrow_h264_tpu_torch"


def _host_run(dec, data: bytes, plane):
    """Drive a Decoder's host half only: parse, pack and commit every
    picture with placeholder planes (plane(shape) makes one) and no device
    store.  Returns (ABIs with every public field copied, POCs in decode
    order, POCs in output order)."""
    abis, pocs, out = [], [], []
    for pic, poc in dec.parse_pictures(data):
        abi = dec.pack_abi(pic, poc)
        abis.append({k: np.array(v) if isinstance(v, np.ndarray) else v
                     for k, v in abi.items() if not k.startswith("_")})
        pocs.append(poc)
        H, W = pic.mb_h * 16, pic.mb_w * 16
        y, cb, cr = (plane(s) for s in ((H, W), (H // 2, W // 2),
                                        (H // 2, W // 2)))
        n_slots = max(2, min(pic.sps.max_num_ref_frames, 32) + 1)
        out += [f.poc for f in dec.commit(pic, poc, y, cb, cr, n_slots,
                                          lambda *a: None)]
    out += [dec._emit(p).poc for p in dec.dpb.flush()]
    return abis, pocs, out


@pytest.mark.parametrize("cfg,entropy", [(4, "cpp"), (1, "python")])
def test_host_half_matches_jax_package(h264ref, tmp_path, cfg, entropy):
    """Config 4 (CABAC, B-frames, weighted prediction) through the C++
    entropy library, config 1 (CAVLC) through the pure-Python parser."""
    data = open(encode(tmp_path, cfg, n_frames=6, seed=80 + cfg), "rb").read()
    port = Decoder(device="cpu", entropy=entropy)
    ref = JaxDecoder(entropy=entropy)
    assert port.entropy == ref.entropy == entropy
    got = _host_run(port, data, lambda s: torch.zeros(s, dtype=torch.uint8))
    want = _host_run(ref, data, lambda s: np.zeros(s, np.uint8))
    assert got[1:] == want[1:]                       # POCs, output order
    assert len(got[0]) == len(want[0]) == 6
    assert sorted(got[1]) != got[1] or cfg == 1      # B-frames reorder
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        assert set(g) == set(w), (i, set(g) ^ set(w))
        for k in w:
            assert np.array_equal(g[k], w[k]), f"frame {i}: field {k}"


@pytest.mark.parametrize("make,kw", [
    ("synthetic_abi", {}), ("synthetic_abi_p", {"bi_frac": 0.3, "n_slots": 3})])
def test_synthetic_abis_match_jax_package(make, kw):
    """The port's copy of the synthetic ABI generators."""
    got = getattr(tsynthetic, make)(7, 5, 11, **kw)
    want = getattr(jsynthetic, make)(7, 5, 11, **kw)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


_LOADED = r"""
import json, sys
from arrow_h264_tpu_torch.host import centropy
lib = centropy.load_lib()
maps = open("/proc/self/maps").read().split()
print(json.dumps({"lib": lib._name, "src": [str(s) for s in centropy._SRC],
                  "so": sorted({m for m in maps if m.endswith(".so")}),
                  "jax_pkg": [m for m in sys.modules
                              if m.split(".")[0] == "arrow_h264_tpu"]}))
"""


def test_centropy_builds_and_loads_in_port():
    """The port's entropy library is built from the port's copy of the C++
    sources into the port's _build/ directory, and nothing is loaded from
    the repository's cpp/ or the JAX package.  Every other build (trace,
    stats, sanitizer and their combinations) has a file of its own there
    (tests/test_torch_host_instruments.py loads the stats and sanitizer
    builds and checks the same of them)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", _LOADED], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    lib = Path(out["lib"])
    assert lib.parent == PORT / "_build" and lib.exists()
    assert all(Path(s).parent == PORT / "host" / "cpp" for s in out["src"])
    assert not [s for s in out["so"]
                if Path(s).resolve().parent == REPO / "cpp"]
    assert out["jax_pkg"] == []
    variants = {centropy.lib_path(*flags) for flags in
                itertools.product((False, True), repeat=3)}
    assert len(variants) == 8 and lib in variants
    assert {p.parent for p in variants} == {PORT / "_build"}
