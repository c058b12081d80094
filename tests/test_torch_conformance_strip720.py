"""The width of config 3 at a small height, on the CPU: a 1280x48 strip
(80 x 3 MBs, config 3: an odd number of MB rows, as 720p's 45) through
the port's Decoder with both orders, equal to the libavcodec golden and
to the JAX package's Decoder.  Every comparison is exact."""

import pytest

from tests.torch_ref import check_strip, strip_case

CFG, SIZE, FRAMES = 3, (1280, 48), 4


@pytest.fixture(scope="module")
def strip(h264ref, tmp_path_factory):
    return strip_case(tmp_path_factory.mktemp("strip"), CFG, SIZE, FRAMES)


def test_strip_jax_equals_golden(strip):
    check_strip(strip, None)


@pytest.mark.parametrize("order", ["phase", "raster"])
def test_strip_port(strip, order):
    check_strip(strip, order)
