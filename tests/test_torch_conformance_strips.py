"""The width of config 5 at a small height, on the CPU: a 3840x32 strip
(240 x 2 MBs, config 4) through the port's Decoder with both orders,
equal to the libavcodec golden and to the JAX package's Decoder.  (The
1280x48 strip of config 3 is in test_torch_conformance_strip720.py: each
file's JAX compile takes most of its time.)  Every comparison is
exact."""

import pytest

from tests.torch_ref import check_strip, strip_case

CFG, SIZE, FRAMES = 4, (3840, 32), 3


@pytest.fixture(scope="module")
def strip(h264ref, tmp_path_factory):
    return strip_case(tmp_path_factory.mktemp("strip"), CFG, SIZE, FRAMES)


def test_strip_jax_equals_golden(strip):
    check_strip(strip, None)


@pytest.mark.parametrize("order", ["phase", "raster"])
def test_strip_port(strip, order):
    check_strip(strip, order)
