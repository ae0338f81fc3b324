"""The batched pipelines' shared point-cloud stages (``parallel/point_stages.py``), on the CPU.

Every pipeline that takes raw planes holds them to the one contract of
``check_planes``; the antenna union puts channel 0 in front when the subsets
lack it; the angle head gives the same points from the union cube as from
every virtual channel, indexed by its own positions.
"""

import numpy as np
import pytest
import torch

from mmwave_radar_processing_tpu_torch import load_cfg, make_inputs
from mmwave_radar_processing_tpu_torch.ops import dft
from mmwave_radar_processing_tpu_torch.parallel import (
    build_full_pipeline,
    build_ground_point_cloud_pipeline,
    build_point_cloud_pipeline,
    build_spectral_maps_pipeline,
    build_synthetic_aperture_pipeline,
    build_velocity_pipeline,
    build_viewer_payload_pipeline,
)
from mmwave_radar_processing_tpu_torch.parallel.point_stages import AngleHead, antenna_union

torch.set_num_threads(2)  # tier-1 runs several xdist workers


@pytest.fixture(scope="module")
def planes(flagship_cfg_path):
    cfg = load_cfg(flagship_cfg_path, array_geometry="ods", array_direction="down")
    return (cfg, *(torch.from_numpy(a) for a in make_inputs(cfg, 2, seed=7)))


def _vels(re):
    return torch.zeros(re.shape[0], 3)


#: each pipeline that shares ``check_planes``, called on ``(re, im, altitude)``
PIPELINES = {
    "point_cloud": lambda cfg: lambda re, im, alt: build_point_cloud_pipeline(
        cfg, device="cpu")(re, im),
    "combined": lambda cfg: lambda re, im, alt: build_full_pipeline(
        cfg, device="cpu")(re, im, alt),
    "velocity": lambda cfg: lambda re, im, alt: build_velocity_pipeline(
        cfg, device="cpu")(re, im, alt),
    "ground": lambda cfg: lambda re, im, alt: build_ground_point_cloud_pipeline(
        cfg, device="cpu")(re, im),
    "spectral_maps": lambda cfg: lambda re, im, alt: build_spectral_maps_pipeline(
        cfg, device="cpu")(re, im),
    "viewer": lambda cfg: lambda re, im, alt: build_viewer_payload_pipeline(
        cfg, include=[], device="cpu")(re, im),
    "synthetic_aperture": lambda cfg: lambda re, im, alt: build_synthetic_aperture_pipeline(
        cfg, device="cpu")(re, im, _vels(re)),
}


@pytest.mark.parametrize("case", ["float64", "frame_shape"])
@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipelines_refuse_planes_off_the_contract(planes, name, case):
    cfg, re, im, alt = planes
    call = PIPELINES[name](cfg)
    if case == "float64":
        with pytest.raises(TypeError, match="float32"):
            call(re.double(), im.double(), alt)
    else:
        with pytest.raises(ValueError, match="expected planes"):
            call(re[..., :-1], im[..., :-1], alt)


@pytest.mark.parametrize("az,el,chans,aoa_start", [
    ((0, 3, 4, 7), (9, 8, 5, 4), [0, 3, 4, 5, 7, 8, 9], 0),
    ((3, 4, 7), (9, 8, 5), [0, 3, 4, 5, 7, 8, 9], 1),
    ((), (9, 8, 5), [0, 5, 8, 9], 1),
    ((), (), [0], 1),
], ids=["with_channel_0", "without_channel_0", "empty_az", "both_empty"])
def test_antenna_union_puts_channel_0_in_front(az, el, chans, aoa_start):
    layout = antenna_union(az, el, reformat_input=True, num_rx=4)
    assert layout.chans.tolist() == chans
    assert (layout.ch0_pos, layout.aoa_start) == (0, aoa_start)
    union = layout.chans[aoa_start:]
    assert union[layout.az_pos].tolist() == list(az)
    assert union[layout.el_pos].tolist() == list(el)
    assert layout.min_planes == 4
    assert antenna_union(az, el, reformat_input=False, num_rx=4).min_planes == max(chans) + 1


def test_angle_head_gives_the_same_points_from_the_union_and_every_channel(planes):
    cfg, re, im, _ = planes
    az, el = (0, 3, 4, 7), (9, 8, 5, 4)
    ns, loops = cfg.num_adc_samples, cfg.frame.loops
    rng, dop = (dft.to_matrix(f) for f in dft.range_doppler_factors(ns, loops))
    R = dft.range_dft_channels(torch.complex(re, im), torch.arange(12), rng,
                               num_rx=cfg.num_rx_antennas,
                               cfgs_per_loop=cfg.chirp_cfgs_per_loop)
    gen = torch.Generator().manual_seed(3)
    r_i = torch.randint(0, ns, (2, 16), generator=gen)
    v_i = torch.randint(0, loops, (2, 16), generator=gen)
    valid = torch.arange(16).expand(2, 16) < torch.tensor([[16], [9]])
    kw = dict(num_angle_bins=64, shift_az_resp=True, shift_el_resp=False)
    every = AngleHead(cfg, az_pos=az, el_pos=el, **kw)(R, dop, r_i, v_i, valid)
    layout = antenna_union(az, el, reformat_input=True, num_rx=cfg.num_rx_antennas)
    union = AngleHead(cfg, az_pos=layout.az_pos, el_pos=layout.el_pos, **kw)(
        R[:, layout.union_idx], dop, r_i, v_i, valid)
    np.testing.assert_allclose(union.numpy(), every.numpy(), rtol=0, atol=1e-5)
    assert not every[~valid].any() and every[valid][:, 0].abs().sum() > 0
