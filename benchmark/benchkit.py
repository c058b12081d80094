"""A small benchmark root for the CPU tests: the real metric readers and
specification, plus two QCIF cells (frames on the device, frames to the
host) over two committed 3-picture streams of tests/data, whose goldens
copy the MD5s that libavcodec gave for them there.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from . import lanes

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
QCIF_STREAMS = ("batch_qcif_s1", "batch_qcif_s4")
QCIF_CELL = "qcif-b4-device"
QCIF_HOST_CELL = "qcif-b4-host"


def qcif_golden(name: str) -> dict:
    """The golden of tests/data/NAME.264 as make_streams writes one."""
    import hashlib

    rel = f"tests/data/{name}.264"
    data = (REPO / rel).read_bytes()
    meta = json.loads((REPO / "tests" / "data" / f"{name}.json").read_text())
    kinds, idr = lanes.structure(data)
    return {"file": rel, "sha256": hashlib.sha256(data).hexdigest(),
            "bytes": len(data), "width": meta["width"],
            "height": meta["height"], "frames": meta["frames"],
            "structure": kinds, "idr": idr, "md5": meta["md5"]}


def make_root(tmp: Path, goldens: dict) -> Path:
    """A checkout-like tree under `tmp`: tmp/BENCHMARK.json (the real one
    with the QCIF cells added), tmp/benchmark with the real readers and
    the QCIF config, traffic and goldens, tmp/tests linked to the repo's.
    Returns tmp/benchmark."""
    root = tmp / "benchmark"
    shutil.copytree(BENCH / "metrics", root / "metrics")
    for d in ("configs", "workloads", "data"):
        (root / d).mkdir(parents=True)
    (tmp / "tests").symlink_to(REPO / "tests")
    for name, g in goldens.items():
        (root / "data" / f"{name}.json").write_text(json.dumps(g))
    (root / "configs" / "h264-qcif-high.json").write_text(json.dumps(
        {"name": "h264-qcif-high", "width": 176, "height": 144,
         "mb_width": 11, "mb_height": 9}))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    output = {w["name"]: json.loads(
        (BENCH / "workloads" / f"{w['traffic']}.json").read_text())["output"]
        for w in spec["workloads"]}
    for cell, out in ((QCIF_CELL, "device"), (QCIF_HOST_CELL, "host")):
        (root / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"config": "h264-qcif-high", "chips": 1, "why": "CPU tests",
             "streams": list(goldens), "lanes": 4, "streams_per_call": 2,
             "output": out}))
        spec["workloads"].append({"name": cell, "config": "h264-qcif-high",
                                  "traffic": cell, "chips": 1,
                                  "why": "CPU tests"})
        for m in spec["per_layer"]:
            if "workloads" in m and any(output.get(w) == out
                                        for w in m["workloads"]):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
