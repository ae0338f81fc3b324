"""The roofline counts reproduce the port's kernel table for #1 and #4."""

import pytest

from port_bench.cost import roofline


def test_os_cfar_detect_bound():
    ops, nbytes = roofline.os_cfar_detect_compact(1024, 63, 70, num_train=(5, 5),
                                                  num_guard=(3, 2), capacity=128)
    assert roofline.bound_seconds(ops, nbytes) * 1e3 == pytest.approx(0.0265, abs=5e-5)
    assert nbytes / roofline.PEAK_HBM_BYTES_S * 1e3 == pytest.approx(0.0061, abs=5e-5)


def test_doppler_az_bound():
    ops, nbytes = roofline.doppler_az_responses(1024, 12, 19, 70, n_angles=60, n_sets=4,
                                                n_rx=4)
    assert roofline.bound_seconds(ops, nbytes) * 1e3 == pytest.approx(0.176, abs=5e-4)
