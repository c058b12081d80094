"""The port imports no JAX, builds nothing at import, and chip_smoke.py
refuses to run without a GPU or without the repository."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

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
    assert not out["built"], "importing the wrappers built the kernels"
    for m in ("api", "convert", "models.pipeline", "ops.transforms",
              "ops.intra", "ops.deblock", "ops.inter", "ops.kernels.build",
              "ops.kernels.intra_phase", "ops.kernels.deblock_phase",
              "ops.kernels.mc"):
        assert f"arrow_h264_tpu_torch.{m}" in out["mods"]


def test_chip_smoke_needs_gpu_and_repo(tmp_path):
    """Without a card (here) chip_smoke.py exits non-zero before printing
    a result, and a copy of it alone, without the repository, fails too."""
    import torch
    if torch.cuda.is_available():
        import pytest
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
