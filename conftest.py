"""Repository-level pytest hooks.

The libavcodec oracle CLI `tools/h264ref` is git-ignored and built on
first use by `tools.streams.ensure_h264ref`.  Under pytest-xdist every
worker would build it at once into the same temporary path, and all but
the first rename would fail.  Building it here, once, in the controller
before any worker starts, leaves the workers a binary that is up to date.

This file imports neither jax nor torch: it also runs where only one of
them is installed.
"""


import subprocess


def pytest_configure(config):
    if hasattr(config, "workerinput"):          # an xdist worker
        return
    from tools.streams import ensure_h264ref
    try:
        ensure_h264ref()
    except (OSError, subprocess.CalledProcessError):
        pass        # the tests that need the oracle report the failure
