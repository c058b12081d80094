"""The port stands alone: it imports neither JAX nor the JAX package, and
builds nothing at import; a header edit changes the kernel library's
name; chip_smoke.py refuses to run without a GPU or without the
repository."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import arrow_h264_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    arrow_h264_tpu_torch.__path__, "arrow_h264_tpu_torch."))
for m in mods:
    importlib.import_module(m)
from arrow_h264_tpu_torch.ops.kernels import build
print(json.dumps({"mods": mods, "jax": "jax" in sys.modules,
                  "jax_pkg": [m for m in sys.modules
                              if m.split(".")[0] == "arrow_h264_tpu"],
                  "built": build._lib is not None}))
"""


def _clean_env():
    """The environment without JAX's test settings, and with no CUDA
    toolkit to be found."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(REPO)
    env["CUDA_HOME"] = str(REPO / "no-cuda-toolkit")
    return env


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                       env=_clean_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert not out["jax"], "the port imported jax"
    assert out["jax_pkg"] == [], "the port imported the JAX package"
    assert not out["built"], "importing the wrappers built the kernels"
    for m in ("api", "convert", "models.pipeline", "ops.transforms",
              "ops.intra", "ops.deblock", "ops.inter", "ops.kernels.build",
              "ops.kernels.intra_phase", "ops.kernels.deblock_phase",
              "ops.kernels.mc", "ops.kernels.intra_raster",
              "ops.kernels.deblock_raster", "ops.kernels.wavefront",
              "host.centropy", "dpb",
              "bitstream.slicehdr", "mb.cabac_parse", "ops.abi"):
        assert f"arrow_h264_tpu_torch.{m}" in out["mods"]


@pytest.mark.parametrize("script", ["chip_smoke.py", "tools/profile_torch.py",
                                    "tools/wavefront_probe.py"])
def test_scripts_import_only_the_port(script):
    """The port's scripts import neither jax nor arrow_h264_tpu."""
    tree = ast.parse((REPO / script).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "arrow_h264_tpu"}, roots
    assert "arrow_h264_tpu_torch" in roots


def test_lib_path_hashes_headers(tmp_path, monkeypatch):
    """The kernel library's name changes when a .cu or an included .cuh
    changes, so a header edit rebuilds; computing it compiles nothing."""
    from arrow_h264_tpu_torch.ops.kernels import build
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    (tmp_path / "k.cuh").write_text("// v1\n")
    first = build.lib_path()
    assert build.lib_path() == first
    (tmp_path / "k.cuh").write_text("// v2\n")
    second = build.lib_path()
    (tmp_path / "k.cu").write_text('#include "k.cuh"  // edited\n')
    assert len({first, second, build.lib_path()}) == 3
    assert build.sources() == [tmp_path / "k.cu"]
    assert not (tmp_path / "_build").exists()


def test_chip_smoke_needs_gpu_and_repo(tmp_path):
    """Without a card (here) chip_smoke.py exits non-zero before printing
    a result, and a copy of it alone, without the repository, fails too."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", lone)
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (lone, tmp_path)):
        env = _clean_env()
        if cwd == tmp_path:
            env.pop("PYTHONPATH")
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
