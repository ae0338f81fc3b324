"""Options of the point-cloud and combined pipelines against the JAX package, on the CPU.

``reformat_input=False`` (already reformatted virtual cubes) and empty antenna
subsets (zero angles on that axis), each through the JAX pipeline and the
port's on the same ``make_inputs`` frames.  Tolerances as
``tests/test_torch_pipeline.py``: counts and validity masks identical, points
within 1e-5 (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

from mmwave_radar_processing_tpu.parallel.full_pipeline import (
    build_full_pipeline as build_jax_full,
)
from mmwave_radar_processing_tpu.parallel.pipeline import (
    build_point_cloud_pipeline as build_jax_pipeline,
)
from mmwave_radar_processing_tpu.processors.virtual_array import reformat as jax_reformat
from mmwave_radar_processing_tpu.utils.verify import make_inputs
from mmwave_radar_processing_tpu_torch import build_full_pipeline, build_point_cloud_pipeline

torch.set_num_threads(2)  # tier-1 runs several xdist workers

CFAR_PARAMS = dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)
AZ, EL = (0, 3, 4, 7), (9, 8, 5, 4)
SUBSETS = {"empty_az": ((), EL), "empty_el": (AZ, ()), "both_empty": ((), ()),
           "empty_az_no_channel_0": ((), (9, 8, 5))}


@pytest.fixture(scope="module")
def frames(flagship_config):
    return make_inputs(flagship_config, 4, seed=7)


def _assert_point_clouds_agree(got, want):
    (pts, valid, count), (j_pts, j_valid, j_count) = got, want
    np.testing.assert_array_equal(count, j_count)
    np.testing.assert_array_equal(valid, j_valid)
    np.testing.assert_allclose(pts, j_pts, rtol=0, atol=1e-5)
    assert count.min() > 0 and not pts[~valid].any()


def _virtual_planes(cfg, raw_re, raw_im):
    virt = np.stack([np.asarray(jax_reformat(
        frame, num_rx=cfg.num_rx_antennas, cfgs_per_loop=cfg.chirp_cfgs_per_loop))
        for frame in raw_re + 1j * raw_im])
    return (np.ascontiguousarray(virt.real, np.float32),
            np.ascontiguousarray(virt.imag, np.float32))


@pytest.mark.parametrize("az,el", [(AZ, EL), ((3, 4, 7), (9, 8, 5))],
                         ids=["flagship_subsets", "channel_0_outside_the_union"])
def test_reformatted_input_matches_jax(flagship_config, frames, az, el):
    cfg = flagship_config
    v_re, v_im = _virtual_planes(cfg, *frames[:2])
    assert v_re.shape == (4, 12, 63, 70)
    kw = dict(az_antenna_idxs=az, el_antenna_idxs=el, cfar_params=CFAR_PARAMS, max_dets=128,
              reformat_input=False)
    want = [np.asarray(a) for a in build_jax_pipeline(
        cfg, backend="mxu", aoa_precision="f32", **kw)(v_re, v_im)]
    port = build_point_cloud_pipeline(cfg, device="cpu", **kw)
    got = [a.numpy() for a in port(torch.from_numpy(v_re), torch.from_numpy(v_im))]
    _assert_point_clouds_agree(got, want)
    # and it is what the raw cubes give: the reformat is a selection of planes
    raw = build_point_cloud_pipeline(cfg, device="cpu", **dict(kw, reformat_input=True))
    for a, b in zip(raw(*(torch.from_numpy(p) for p in frames[:2])), got):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5)


def test_reformatted_input_rejects_raw_cubes(flagship_config, frames):
    port = build_point_cloud_pipeline(flagship_config, device="cpu", reformat_input=False)
    with pytest.raises(ValueError, match="expected planes"):
        port(torch.from_numpy(frames[0]), torch.from_numpy(frames[1]))
    v_re, v_im = _virtual_planes(flagship_config, *frames[:2])
    with pytest.raises(ValueError, match="expected planes"):  # too few virtual channels
        port(torch.from_numpy(v_re[:, :9]), torch.from_numpy(v_im[:, :9]))


@pytest.mark.parametrize("name", list(SUBSETS))
def test_empty_antenna_subsets_match_jax(flagship_config, frames, name):
    az, el = SUBSETS[name]
    kw = dict(az_antenna_idxs=az, el_antenna_idxs=el, cfar_params=CFAR_PARAMS, max_dets=128)
    want = [np.asarray(a) for a in build_jax_pipeline(
        flagship_config, backend="mxu", aoa_precision="f32", **kw)(*frames[:2])]
    port = build_point_cloud_pipeline(flagship_config, device="cpu", **kw)
    got = [a.numpy() for a in port(*(torch.from_numpy(p) for p in frames[:2]))]
    _assert_point_clouds_agree(got, want)
    pts, valid, _ = got
    # zero angles: azimuth 0 puts a point at y = 0, elevation 0 at z = 0 (FLU)
    if not az:
        assert not pts[..., 1].any()
    if not el:
        assert not pts[..., 2].any()
    assert pts[valid][:, 0].any()


@pytest.mark.parametrize("name", ["empty_az", "empty_el", "both_empty"])
def test_combined_pipeline_takes_empty_subsets_as_jax_does(flagship_config, frames, name):
    az, el = SUBSETS[name]
    kw = dict(az_antenna_idxs=az, el_antenna_idxs=el, cfar_params=CFAR_PARAMS, max_dets=128)
    # the JAX default "fast" runs in float32 on the CPU
    want, _ = build_jax_full(flagship_config, **kw)(*frames)
    port = build_full_pipeline(flagship_config, device="cpu", **kw)
    got, vel = port(*(torch.from_numpy(a) for a in frames))
    _assert_point_clouds_agree([a.numpy() for a in got], [np.asarray(a) for a in want])
    assert vel.velocity.shape == (4, 3) and bool(torch.isfinite(vel.velocity).all())
