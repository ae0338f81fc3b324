"""The port's multi-device layer on gloo ranks on the CPU, against its unsharded ops and the JAX package.

One spawn of ranks a world size (1, 2 and 4; a module-scoped fixture) runs
``parallel.rank_checks.run_rank``: every sharded builder on its shard of
the same seeded numpy inputs, the builders' errors, the feed, the dry run
and the scaling body.  Each check below is its own test case.

- Bit-equal to the port's unsharded ops: the three halo CFARs, the
  overlap-save zoom and ``shard_pipeline`` over the point-cloud pipeline
  (8 flagship frames).
- Against the JAX package's sharded functions on the virtual mesh
  ``make_mesh({"data": n})`` of ``tests/conftest.py``: the 1D OS thresholds
  and the 2D detection mask equal, the CA thresholds within rtol 1e-6, the
  zoom within 1e-5 of its maximum, the beamformers within 1e-4 of the
  maximum, the point clouds at the parity bars of
  ``tests/test_torch_pipeline.py`` (counts and masks equal, points within
  1e-5).
"""

import os
import re
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mmwave_radar_processing_tpu.config import grids as jax_grids
from mmwave_radar_processing_tpu.ops import beamform as jax_bf, windows as jax_windows
from mmwave_radar_processing_tpu.ops.mxu import C2
from mmwave_radar_processing_tpu.parallel import halo_cfar as jax_halo
from mmwave_radar_processing_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mmwave_radar_processing_tpu.parallel.overlap_save import (
    build_sharded_zoom_fir as jax_sharded_zoom,
)
from mmwave_radar_processing_tpu.parallel.pipeline import (
    build_point_cloud_pipeline as jax_point_cloud,
    shard_pipeline as jax_shard_pipeline,
)
from mmwave_radar_processing_tpu.parallel.sharded_beamform import (
    build_sharded_beamformer as jax_sharded_beamformer,
    build_snapshot_sharded_capon as jax_snapshot_capon,
)
from mmwave_radar_processing_tpu_torch.parallel import rank_checks
from mmwave_radar_processing_tpu_torch.parallel.launch import spawn
from mmwave_radar_processing_tpu_torch.parallel.scaling import (
    predict_link_efficiency, scaling_table, write_feed_frames,
)

WORLDS = (1, 2, 4)
#: seconds a spawn of ranks may take (each finishes in under 10 s here)
SPAWN_TIMEOUT = 120
HALO_CHECKS = ("os_cfar_1d", "ca_cfar_2d", "os_cfar_2d_detect")
BEAMFORMERS = ("beamformer", "capon", "bartlett")


class Run(NamedTuple):
    world: int
    spec: dict
    arrays: dict  # the global inputs
    want: dict  # the port's unsharded ops on them
    ranks: list  # each rank's result
    got: dict  # the ranks' outputs put together
    jax: dict  # the JAX package's sharded functions on them


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def run(request, flagship_config):
    """One spawn of gloo ranks at this world size; the JAX side runs here meanwhile."""
    world = request.param
    with tempfile.TemporaryDirectory(prefix="mrp_multidevice_") as root, \
            ThreadPoolExecutor(1) as pool:
        spec = rank_checks.small_spec(world, os.path.join(root, "feed"))
        arrays = rank_checks.write_inputs(root, spec)
        feed = spec["feed"]
        write_feed_frames(feed["dir"], feed["frame_shape"], feed["frames"])
        ranks = pool.submit(spawn, rank_checks.run_rank, world, backend="gloo", device="cpu",
                            args=(root, spec), timeout=SPAWN_TIMEOUT)
        jax_out = _jax_outputs(world, spec, arrays, flagship_config)
        ranks = ranks.result()
    want = rank_checks.unsharded(spec, arrays, "cpu")
    return Run(world, spec, arrays, want, ranks, rank_checks.assemble(spec, ranks), jax_out)


def _put(mesh, x, spec):
    return jax.device_put(x, NamedSharding(mesh, spec))


def _case(spec, name):
    return next(c for c in spec["halo"] if c["name"] == name)


# --------------------------------------------------------------------------- #
# bit-equal to the port's unsharded ops
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", HALO_CHECKS)
def test_halo_cfar_is_bit_equal_to_the_unsharded_op(run, name):
    world, want, got = run.world, run.want, run.got
    assert got[name].shape == want[name].shape
    np.testing.assert_array_equal(got[name], want[name])
    # the edge convention: +inf thresholds (False detections) at the true ends
    edge = got[name][..., :3] if name == "os_cfar_1d" else got[name][:3]
    assert (not edge.any()) if edge.dtype == bool else np.isinf(edge).all()


def test_overlap_save_zoom_is_bit_equal_to_the_unsharded_op(run):
    want, got = run.want, run.got
    assert got["zoom"].shape == (3, 48) and got["zoom"].dtype == np.complex64
    np.testing.assert_array_equal(got["zoom"], want["zoom"])


def test_shard_pipeline_is_bit_equal_to_the_unsharded_pipeline(run):
    want, ranks, got = run.want, run.ranks, run.got
    for key in ("pipeline/points", "pipeline/valid", "pipeline/count"):
        np.testing.assert_array_equal(got[key], want[key])
    world = len(ranks)
    assert all(r["outputs"]["pipeline/count"].shape == (8 // world,) for r in ranks)
    assert want["pipeline/count"].min() > 0


@pytest.mark.parametrize("name", BEAMFORMERS)
def test_sharded_beamformers_are_close_to_the_dense_form(run, name):
    want, got = run.want, run.got
    top = np.abs(want[name]).max()
    np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-4 * top)


# --------------------------------------------------------------------------- #
# against the JAX package's sharded functions on the virtual mesh
# --------------------------------------------------------------------------- #
def _jax_outputs(world, spec, arrays, flagship_config):
    """The JAX package's sharded functions on the same inputs, on ``make_mesh({"data": n})``."""
    mesh = jax_make_mesh({"data": world}, jax.devices()[:world])
    out = {}
    builders = {"os_cfar_1d": (jax_halo.os_cfar_1d_sharded, P("data")),
                "ca_cfar_2d": (jax_halo.ca_cfar_2d_row_sharded, P("data", None)),
                "os_cfar_2d_detect": (jax_halo.os_cfar_2d_detect_row_sharded, P("data", None))}
    data, positions = arrays["bf_data"], arrays["bf_positions"]
    ns, e = data.shape
    snaps = arrays["snapshots"]
    steering = jax_bf.steering_ula(jax_grids.phase_shift_bins(spec["capon"]["angles"]),
                                   snaps.shape[1])
    z = arrays["zoom"]
    with mesh:
        for name, (build, part) in builders.items():
            fn = build(mesh, axis="data", **_case(spec, name)["params"])
            out[name] = np.asarray(fn(_put(mesh, arrays[name], part)))
        zoom = jax_sharded_zoom(mesh, n=z.shape[-1], axis="data", **spec["zoom"]["params"])(
            C2(_put(mesh, np.ascontiguousarray(z.real), P(None, "data")),
               _put(mesh, np.ascontiguousarray(z.imag), P(None, "data"))))
        out["zoom"] = np.asarray(zoom.re) + 1j * np.asarray(zoom.im)
        beam = jax_sharded_beamformer(mesh, lambda_m=flagship_config.lambda_m, axis="data")
        out["beamformer"] = np.asarray(beam(
            _put(mesh, data, P(None, "data")), _put(mesh, positions, P(None, "data")),
            jnp.asarray(arrays["bf_steering"]), jnp.asarray(jax_windows.hanning(ns)),
            jnp.asarray(jax_windows.hamming(e))))
        xr = _put(mesh, np.ascontiguousarray(snaps.real), P(None, None, "data"))
        xi = _put(mesh, np.ascontiguousarray(snaps.imag), P(None, None, "data"))
        for method in ("capon", "bartlett"):
            fn = jax_snapshot_capon(mesh, loading=spec["capon"]["loading"], method=method,
                                    axis="data")
            out[method] = np.asarray(fn(xr, xi, steering.re, steering.im))
    pipeline = jax_shard_pipeline(jax_point_cloud(
        flagship_config, az_antenna_idxs=(0, 3, 4, 7), el_antenna_idxs=(9, 8, 5, 4),
        cfar_params=rank_checks.FLAGSHIP_CFAR, max_dets=128, backend="mxu",
        aoa_precision="f32"), mesh)
    pc = pipeline(_put(mesh, arrays["raw_re"], P("data")), _put(mesh, arrays["raw_im"], P("data")))
    for key, value in zip(("points", "valid", "count"), pc):
        out[f"pipeline/{key}"] = np.asarray(value)
    return out


@pytest.mark.parametrize("name", HALO_CHECKS)
def test_halo_cfar_matches_jax(run, name):
    got, want = run.got[name], run.jax[name]
    if name == "ca_cfar_2d":
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_overlap_save_zoom_matches_jax(run):
    want = run.jax["zoom"]
    np.testing.assert_allclose(run.got["zoom"], want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", BEAMFORMERS)
def test_sharded_beamformers_match_jax(run, name):
    want = run.jax[name]
    np.testing.assert_allclose(run.got[name], want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_sharded_point_clouds_match_jax(run):
    got, jax_out = run.got, run.jax
    np.testing.assert_array_equal(got["pipeline/count"], jax_out["pipeline/count"])
    np.testing.assert_array_equal(got["pipeline/valid"], jax_out["pipeline/valid"])
    np.testing.assert_allclose(got["pipeline/points"], jax_out["pipeline/points"], rtol=0,
                               atol=1e-5)


# --------------------------------------------------------------------------- #
# errors, the feed, the dry run, the scaling body, the launcher
# --------------------------------------------------------------------------- #
ERRORS = {
    "halo_rows_per_shard": "rows_per_shard >= num_train \\+ num_guard \\(= 10\\)",
    "zoom_decim": "must be a multiple of decim=4",
    "zoom_samples_per_shard": "samples_per_shard >= num_taps - 1 \\(= 32\\)",
    "zoom_n_divides": "must divide over",
    "mesh_two_unknown": "at most one axis may be -1",
    "mesh_wrong_size": "does not match",
    "split_complex": "split_complex=True is a TPU workaround",
    "capon_method": "unknown method",
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_builders_raise_where_jax_raises(run, name):
    world, ranks = run.world, run.ranks
    for r in ranks:
        message = r["errors"][name]
        if name == "zoom_n_divides" and world == 1:
            assert message is None  # 17 samples divide over one shard
        else:
            assert message is not None and re.search(ERRORS[name], message), (name, message)


def test_feed_loads_each_rank_its_own_frames(run):
    world, spec, ranks = run.world, run.spec, run.ranks
    feed = spec["feed"]
    model = 2 if world % 2 == 0 else 1
    per = feed["global_batch"] // (world // model)
    for r in ranks:
        data_row, model_col = r["feed"]["coords"]
        assert r["rank"] == data_row * model + model_col
        # ownership along the data axis only: a data row's ranks load the same frames
        assert r["feed"]["share"] == (data_row * per, (data_row + 1) * per)
        assert r["feed"]["batches"] == feed["frames"] // feed["global_batch"] == 2
        assert r["feed"]["frames"] == 2 * per
        # each batch, compared after every batch was taken, equals a straight load
        assert r["feed"]["equal"] == [True, True]


def test_dry_run_runs_every_step(run):
    world, ranks = run.world, run.ranks
    model = 2 if world % 2 == 0 else 1
    for r in ranks:
        d = r["dryrun"]
        assert d["mesh"] == {"data": world // model, "model": model}
        shapes = d["shapes"]
        assert shapes["point_cloud"] == [2 * model, 32, 4]
        assert shapes["combined_velocity"] == [2 * model, 3]
        assert shapes["beamform"] == [32, 24] and shapes["capon"] == [32, 24]
        assert shapes["os_cfar_1d"] == [64] and shapes["zoom"] == [2, 16]
        assert not any(d["launches"].values())  # no kernel runs on the CPU


def test_scaling_table_has_the_jax_keys(run):
    world, ranks = run.world, run.ranks
    table = scaling_table({world: ("gloo", [r["scaling"] for r in ranks])},
                          per_device_batch=1, device="cpu")
    names = ["combined", "combined_with_feed", "halo_cfar_2d", "capon_snapshot"]
    if world >= 2:
        names += ["ppermute_halo_rows", "psum_beamform_partials"]
    else:
        assert "ppermute_halo_rows" not in table
    for name in names:
        entry = table[name]
        for key in ("devices", "samples_per_s", "efficiency", "device_oversubscribed"):
            assert len(entry[key]) == 1, (name, key)
        assert entry["devices"] == [world] and entry["samples_per_s"][0] > 0
    assert table["combined_with_feed"]["input_feed_included"] == [True]
    assert table["combined"]["input_feed_included"] == [False]
    for pipe in ("halo_cfar_2d", "capon_snapshot"):
        assert len(table[pipe]["collective_share"]) == 1
        assert (table[pipe]["collective_share"][0] == 0.0) == (world == 1)
    # the rows the exchange sends: train + guard = 6, to both neighbours, float32
    assert table["halo_cfar_2d"]["halo_bytes_per_dev"] == 2 * 6 * 128 * 4
    assert table["capon_snapshot"]["psum_bytes_per_dev"] == 64 * 12 * 12 * 8
    assert table["meta"]["backends"] == {world: "gloo"}
    proj = predict_link_efficiency(table, device_counts=[1, 2, 4, 8], link_bw_gbs=450.0,
                                   link_latency_us=5.0)
    assert proj["assumptions"] == {"link_bw_gbs": 450.0, "link_latency_us": 5.0}
    for pipe in ("combined_with_feed", "halo_cfar_2d", "capon_snapshot"):
        assert all(0.0 < v <= 1.0 for v in proj["pipelines"][pipe]["eff_pred"].values())


def test_link_projection_models():
    results = {"combined": {"samples_per_s": [100.0]},
               "combined_with_feed": {"samples_per_s": [80.0]},
               "halo_cfar_2d": {"samples_per_s": [1e6], "samples_per_step_n1": 1000,
                                "halo_bytes_per_dev": 1000},
               "capon_snapshot": {"samples_per_s": [1e6], "samples_per_step_n1": 1000,
                                  "psum_bytes_per_dev": 1000}}
    proj = predict_link_efficiency(results, device_counts=[1, 2, 4], link_bw_gbs=1.0,
                                   link_latency_us=1.0)
    pipes = proj["pipelines"]
    assert pipes["combined_with_feed"]["eff_pred"][4] == pytest.approx(1 / 1.25)
    # t_comp 1 ms; exchange 1 us + 1 us
    assert pipes["halo_cfar_2d"]["eff_pred"][2] == pytest.approx(1e-3 / (1e-3 + 2e-6))
    # ring all-reduce at n = 4: 2 * 1000 * 3/4 / 1e9 + 2 * 2 * 1e-6
    assert pipes["capon_snapshot"]["eff_pred"][4] == pytest.approx(1e-3 / (1e-3 + 5.5e-6))
    assert proj["min_predicted_efficiency"] == pytest.approx(0.8)
    assert proj["meets_80pct_bar"]


def test_on_the_cpu_no_kernel_launches(run):
    ranks = run.ranks
    for r in ranks:
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert not any(n for launched in r["launches"].values() for n in launched.values())


def test_a_failing_rank_fails_the_spawn_with_its_traceback(tmp_path):
    missing = str(tmp_path / "no_inputs_here")
    with pytest.raises(RuntimeError, match="rank [01] of 2 failed") as info:
        spawn(rank_checks.run_rank, 2, backend="gloo", device="cpu",
              args=(missing, rank_checks.small_spec(2, missing)), timeout=60)
    assert "Traceback" in str(info.value) and "run_rank" in str(info.value)


def test_spawn_checks_its_arguments():
    with pytest.raises(ValueError, match="backend"):
        spawn(rank_checks.run_rank, 1, backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="nccl backend needs device='cuda'"):
        spawn(rank_checks.run_rank, 1, backend="nccl", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            spawn(rank_checks.run_rank, 1, backend="gloo", device="cuda")


def test_make_mesh_needs_a_process_group():
    from mmwave_radar_processing_tpu_torch.parallel.mesh import make_mesh

    if torch.distributed.is_initialized():
        pytest.skip("a process group is initialized in this process")
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_mesh({"data": 1}, device_type="cpu")


def test_inputs_are_written_for_the_ranks(tmp_path):
    spec = rank_checks.small_spec(2, str(tmp_path / "feed"))
    arrays = rank_checks.write_inputs(str(tmp_path), spec)
    for name, arr in arrays.items():
        np.testing.assert_array_equal(np.load(os.path.join(tmp_path, f"{name}.npy")), arr)
    feed = spec["feed"]
    paths = write_feed_frames(feed["dir"], feed["frame_shape"], feed["frames"])
    assert sorted(os.listdir(tmp_path / "feed")) == [os.path.basename(p) for p in paths]
    assert np.load(paths[0]).shape == spec["feed"]["frame_shape"]
