"""The roofline counts reproduce the port's kernel table; the roofline readers take the cell's shapes."""

import pytest

from port_bench.cost import roofline
from port_bench.lib.harness import Cell, metric_modules
from port_bench.lib.trace import Trace


def test_os_cfar_detect_bound():
    ops, nbytes = roofline.os_cfar_detect_compact(1024, 63, 70, num_train=(5, 5),
                                                  num_guard=(3, 2), capacity=128)
    assert roofline.bound_seconds(ops, nbytes) * 1e3 == pytest.approx(0.0265, abs=5e-5)
    assert nbytes / roofline.PEAK_HBM_BYTES_S * 1e3 == pytest.approx(0.0061, abs=5e-5)


def test_doppler_az_bound():
    ops, nbytes = roofline.doppler_az_responses(1024, 12, 19, 70, n_angles=60, n_sets=4,
                                                n_rx=4)
    assert roofline.bound_seconds(ops, nbytes) * 1e3 == pytest.approx(0.176, abs=5e-4)


def test_prominent_peak_bound():
    rows, n = 1024 * 2 * 70, 60
    ops, nbytes = roofline.prominent_peak(rows, n)
    assert ops == rows * n
    assert 4.0 * rows * n == pytest.approx(34.4e6, rel=1e-3)  # in
    assert nbytes - 4.0 * rows * n == pytest.approx(1.29e6, rel=1e-3)  # out
    assert roofline.bound_seconds(ops, nbytes) * 1e3 == pytest.approx(0.0107, abs=5e-5)


@pytest.mark.parametrize("metric,kernel,cost", [
    ("prominent_peak.roofline_pct", "void (anonymous namespace)::prominent_peak_kernel()",
     roofline.prominent_peak(4096 * 2 * 70, 60)),
    ("doppler_az.roofline_pct", "void doppler_az_responses_kernel<4>()",
     roofline.doppler_az_responses(4096, 12, 19, 70, n_angles=60, n_sets=4, n_rx=4)),
])
def test_roofline_readers_take_the_cell_shapes(metric, kernel, cost):
    """At ``ods20-combined-bulk``'s shapes two calls of 1 ms read the bound over 1 ms; none read None."""
    reader = metric_modules()[metric]
    cell = Cell.load("ods20-combined-bulk")
    calls = [(kernel, 0.0, 1000.0), (kernel, 2000.0, 1000.0)]
    trace = Trace(window_s=1.0, frames=8192, kernels=calls, device_ops=calls)
    bound_ms = roofline.bound_seconds(*cost) * 1e3
    assert reader.read({"cell": cell, "trace": trace}) == pytest.approx(100.0 * bound_ms)
    assert reader.read({"cell": cell, "trace": Trace(window_s=1.0, frames=0)}) is None
