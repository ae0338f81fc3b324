"""The port's point-cloud pipeline against the JAX ``union`` pipeline, on the CPU.

Both run ``utils/verify.make_inputs`` frames; the JAX side uses
``aoa_precision="f32"`` (the full-float32 mode the port implements).
Counts and validity masks must be identical and points within 1e-5.
"""

import numpy as np
import pytest
import torch

from mmwave_radar_processing_tpu.config import grids
from mmwave_radar_processing_tpu.ops import mxu
from mmwave_radar_processing_tpu.parallel.pipeline import (
    build_point_cloud_pipeline as build_jax_pipeline,
)
from mmwave_radar_processing_tpu.utils.verify import compare_outputs, make_inputs
from mmwave_radar_processing_tpu_torch import (
    build_point_cloud_pipeline,
    load_reference_constants,
)

torch.set_num_threads(2)  # tier-1 runs several xdist workers

CFAR_PARAMS = dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)
AZ, EL = (0, 3, 4, 7), (9, 8, 5, 4)


@pytest.fixture(scope="module")
def frames(flagship_config):
    raw_re, raw_im, _ = make_inputs(flagship_config, 8, seed=7)
    return raw_re, raw_im


def _run_both(cfg, raw_re, raw_im, az=AZ, el=EL):
    jax_fn = build_jax_pipeline(cfg, az_antenna_idxs=az, el_antenna_idxs=el,
                                cfar_params=CFAR_PARAMS, max_dets=128,
                                backend="mxu", aoa_precision="f32")
    want = [np.asarray(a) for a in jax_fn(raw_re, raw_im)]
    port = build_point_cloud_pipeline(cfg, az_antenna_idxs=az, el_antenna_idxs=el,
                                      cfar_params=CFAR_PARAMS, max_dets=128,
                                      device="cpu")
    got = [a.numpy() for a in port(torch.from_numpy(raw_re), torch.from_numpy(raw_im))]
    return got, want


@pytest.fixture(scope="module")
def outputs(flagship_config, frames):
    return _run_both(flagship_config, *frames)


def test_slice_matches_jax_union_f32(outputs):
    (pts, valid, count), (j_pts, j_valid, j_count) = outputs
    assert pts.shape == (8, 128, 4) and pts.dtype == np.float32
    assert valid.shape == (8, 128) and valid.dtype == bool
    assert count.shape == (8,) and count.dtype == np.int32
    np.testing.assert_array_equal(count, j_count)
    np.testing.assert_array_equal(valid, j_valid)
    # float32 sums in another order; measured 3.6e-7 at batch 16
    np.testing.assert_allclose(pts, j_pts, rtol=0, atol=1e-5)
    # the truncation to the first 128 detections is exercised, and
    # invalid rows are zero
    assert (count == 128).any() and count.min() > 0
    assert not pts[~valid].any()


def test_slice_passes_raised_gates(outputs):
    got, want = outputs
    names = ("points", "valid", "count")
    report = compare_outputs(
        {f"pointcloud_f32/{n}": w for n, w in zip(names, want)},
        {f"pointcloud_f32/{n}": g for n, g in zip(names, got)})
    assert report["ok"], report
    gated = {leaf["leaf"]: leaf for leaf in report["leaves"]}
    assert gated["pointcloud_f32/points"]["gate"] == 0.95
    assert gated["pointcloud_f32/points"]["agree_frac"] == 1.0


def test_channel0_outside_the_union_matches_jax(flagship_config, frames):
    """AoA subsets without channel 0: the CFAR map still comes from channel 0."""
    raw_re, raw_im = (a[:4] for a in frames)
    (pts, valid, count), (j_pts, j_valid, j_count) = _run_both(
        flagship_config, raw_re, raw_im, az=(3, 4, 7), el=(9, 8, 5))
    np.testing.assert_array_equal(count, j_count)
    np.testing.assert_array_equal(valid, j_valid)
    np.testing.assert_allclose(pts, j_pts, rtol=0, atol=1e-5)


def _jax_constants(az=AZ, el=EL):
    (rc, rs), (dc, ds) = mxu.range_doppler_factors(63, 70)
    azc, azs = mxu.aoa_factors(len(az), 64, True)
    elc, els = mxu.aoa_factors(len(el), 64, False)
    union_idx, az_pos, el_pos, _ = mxu.aoa_union_layout(np.asarray(az),
                                                        np.asarray(el))
    consts = dict(rng_cos=rc, rng_sin=rs, dop_cos=dc, dop_sin=ds, az_cos=azc,
                  az_sin=azs, el_cos=elc, el_sin=els,
                  angle_bins=grids.angle_bins(64).astype(np.float32))
    consts = {k: np.asarray(v) for k, v in consts.items()}
    consts.update(union_idx=union_idx, az_pos=az_pos, el_pos=el_pos)
    return consts


def test_constants_carry_over_from_jax(flagship_config, frames):
    consts = _jax_constants()
    native = build_point_cloud_pipeline(flagship_config, device="cpu")
    # the port's own builders give the JAX package's constants, bit for bit
    for buf, (c, s) in {"rng_dft": ("rng_cos", "rng_sin"),
                        "dop_dft": ("dop_cos", "dop_sin"),
                        "head.az_dft": ("az_cos", "az_sin"),
                        "head.el_dft": ("el_cos", "el_sin")}.items():
        m = native.get_buffer(buf)
        np.testing.assert_array_equal(m.real.numpy(), consts[c])
        np.testing.assert_array_equal(m.imag.numpy(), -consts[s])
    np.testing.assert_array_equal(native.head.angle_bins.numpy(), consts["angle_bins"])

    loaded = build_point_cloud_pipeline(flagship_config, device="cpu")
    with torch.no_grad():
        for buf in ("rng_dft", "dop_dft", "head.az_dft", "head.el_dft", "head.angle_bins"):
            loaded.get_buffer(buf).zero_()
    load_reference_constants(loaded, consts)
    raw = [torch.from_numpy(a[:2]) for a in frames]
    for g, w in zip(loaded(*raw), native(*raw)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("fault", ["missing", "unknown", "layout", "shape"])
def test_load_reference_constants_rejects_mismatches(flagship_config, fault):
    consts = _jax_constants()
    if fault == "missing":
        del consts["dop_sin"]
    elif fault == "unknown":
        consts["extra"] = np.zeros(1)
    elif fault == "layout":  # constants of another antenna layout
        consts = _jax_constants(az=(3, 4, 7), el=(9, 8, 5))
    else:
        consts["angle_bins"] = consts["angle_bins"][:32]
    pipeline = build_point_cloud_pipeline(flagship_config, device="cpu")
    with pytest.raises(ValueError):
        load_reference_constants(pipeline, consts)


@pytest.mark.parametrize("option", [dict(backend="xla"), dict(dataflow="raw"),
                                    dict(dataflow="rawd"),
                                    dict(aoa_precision="fast"),
                                    dict(aoa_precision="exact"),
                                    dict(reformat_input=None),
                                    dict(dataflow="raw", reformat_input=False)],
                         ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_options_left_out_of_the_port_raise(flagship_config, option):
    with pytest.raises(ValueError):
        build_point_cloud_pipeline(flagship_config, device="cpu", **option)


@pytest.mark.parametrize("case", ["shape", "dtype", "mismatch"])
def test_forward_rejects_bad_input(flagship_config, frames, case):
    pipeline = build_point_cloud_pipeline(flagship_config, device="cpu")
    re, im = (torch.from_numpy(a[:1]) for a in frames)
    err = ValueError
    if case == "shape":
        re, im = re[..., :200], im[..., :200]
    elif case == "dtype":
        re, im, err = re.double(), im.double(), TypeError
    else:  # planes of two batch sizes
        im = torch.cat([im, im])
    with pytest.raises(err):
        pipeline(re, im)


def test_pipeline_state_is_buffers(flagship_config):
    pipeline = build_point_cloud_pipeline(flagship_config, device="cpu")
    assert not list(pipeline.parameters())
    names = {n for n, _ in pipeline.named_buffers()}
    assert {"rng_dft", "dop_dft", "head.az_dft", "head.el_dft", "head.angle_bins"} <= names
    assert pipeline.rng_dft.dtype == torch.complex64
