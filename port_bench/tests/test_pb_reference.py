"""The plain reference agrees with the port on the CPU at tiny sizes."""

import numpy as np
import pytest
import torch

from port_bench.gen import scene
from port_bench.lib import compare
from port_bench.lib.harness import Cell
from port_bench.reference import pointcloud as ref_pc
from port_bench.reference import velocity as ref_vel
from port_bench.traffic.bulk import build_pipeline


def _port_cfg(cell):
    from port_bench.lib.harness import Context

    return Context(cell, 0, torch.device("cpu")).port_config()


@pytest.mark.parametrize("name", ["ods20-combined-bulk", "ods10-pointcloud-bulk"])
def test_point_cloud_agrees(name):
    cell = Cell.load(name)
    re, im, alt = scene.frames(cell.radar, 6, 31, "cpu")
    port = build_pipeline("pointcloud", _port_cfg(cell), cell.config["processing"], "cpu")
    with torch.no_grad():
        got = port(re, im)
        ref = ref_pc.point_cloud(re, im, cell.radar, cell.config["processing"], block=4)
    assert torch.equal(got.valid, ref.valid)
    assert torch.equal(got.count.long(), ref.count)
    assert torch.allclose(got.points, ref.points, atol=1e-5)
    nums = compare.cloud_numbers(got.points.numpy(), got.valid.numpy(), ref.points.numpy(),
                                 ref.valid.numpy(), range_res=cell.radar.range_res,
                                 vel_max=cell.radar.vel_max, vel_res=cell.radar.vel_res)
    assert nums == {"det_mismatch": 0.0, "angle_mismatch": 0.0}


def test_velocity_agrees():
    cell = Cell.load("ods20-combined-bulk")
    re, im, alt = scene.frames(cell.radar, 8, 32, "cpu")
    draws = scene.gumbel((8, 2, 20, cell.radar.loops), 5, "cpu")
    port = build_pipeline("combined", _port_cfg(cell), cell.config["processing"], "cpu")
    with torch.no_grad():
        _, vel = port(re, im, alt, gumbel=draws)
        ref = ref_vel.velocity(re, im, alt, draws, cell.radar, cell.config["processing"],
                               block=3)
    assert torch.allclose(vel.velocity, ref.velocity, atol=1e-5)
    fit = torch.stack([vel.az_r2, vel.el_r2, vel.az_inlier, vel.el_inlier], dim=-1)
    assert torch.allclose(fit, ref.fit, atol=1e-5)
    assert (vel.vx != 0).any()


def test_grids_match_the_port():
    from mmwave_radar_processing_tpu_torch.config import grids

    for name in ("ods20-combined-bulk", "ods10-pointcloud-bulk"):
        cell = Cell.load(name)
        cfg = _port_cfg(cell)
        r = cell.radar
        assert (r.range_res, r.range_max, r.vel_res, r.vel_max) == pytest.approx(
            (cfg.range_res_m, cfg.range_max_m, cfg.vel_res_m_s, cfg.vel_max_m_s), rel=1e-12)
        assert np.array_equal(r.vel_bins(), grids.vel_bins(cfg))
        assert np.array_equal(r.range_bins(), grids.range_bins(cfg, "eps"))


def test_tf32_rounding():
    from port_bench.reference.dsp import round_tf32

    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.5, 0.0])
    assert round_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9, -3.5, 0.0]
    y = torch.randn(1000)
    assert torch.all((round_tf32(y) - y).abs() <= y.abs() * 2 ** -11)
