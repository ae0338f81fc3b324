"""Every sharded builder driven on each rank, beside the port's unsharded ops: the multi-device checks.

One spawn of ranks (:func:`.launch.spawn`) runs :func:`run_rank`, which
drives, on its own shard of inputs written once by the parent
(:func:`write_inputs`, numpy from a seed):

- ``shard_pipeline`` over the point-cloud or the combined pipeline;
- the three halo CFARs and the overlap-save zoom;
- the element-sharded beamformer and the snapshot-sharded Capon and
  Bartlett;
- the feed (:func:`.input_feed.sharded_recording_feed`) over an NPY
  recording on a ``(data, model)`` mesh, each batch held to a straight
  load of the rank's frames after every batch has been taken, and
  optionally through the sharded combined pipeline;
- the builders' errors, the dry run (:func:`.dryrun.dryrun_rank`) and the
  scaling body (:func:`.scaling.scaling_rank`).

Each rank returns its local outputs as numpy with each check's kernel
launches.  The parent puts the shards together (:func:`assemble`) and
holds them to :func:`unsharded`, the port's unsharded ops on the same
inputs.  The tests run this on the CPU with gloo ranks (:func:`small_spec`)
and also hold the result to the JAX package; ``chip_smoke.py`` runs it on
the card at full width (:func:`full_spec`).

Frame, row and sample axes are split over ``data`` (a one-axis mesh of
every rank); elements and snapshots over ``model`` (the same ranks).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from mmwave_radar_processing_tpu_torch.config import grids
from mmwave_radar_processing_tpu_torch.ops.kernels import count_launches
from mmwave_radar_processing_tpu_torch.parallel.dryrun import dryrun_rank
from mmwave_radar_processing_tpu_torch.parallel.mesh import frame_slice
from mmwave_radar_processing_tpu_torch.parallel.scaling import (
    frame_paths, synchronize, write_feed_frames,
)
from mmwave_radar_processing_tpu_torch.utils.verify import (
    CFAR_PARAMS as FLAGSHIP_CFAR, flagship_config,
)
#: the velocity pipeline's RANSAC draws ``[B, 2 fits, 20 trials, rows]``
RANSAC_DRAWS = (2, 20, 70)
ZOOM_PARAMS = dict(f_center=0.31, fs=2.0, decim=4, num_taps=33, m=48, f1=-0.2, f2=0.2)


def small_spec(world: int, feed_dir: str) -> Dict:
    """The CPU tests' sizes: the JAX package's test shapes, 8 flagship frames.

    ``feed_dir``: where the feed's recording is written
    (:func:`.scaling.write_feed_frames` of ``feed["frames"]`` frames).
    """
    return {
        "pipeline": {"kind": "point_cloud", "batch": 8, "frames": "simulated", "max_dets": 128},
        "halo": [
            {"name": "os_cfar_1d", "op": "os_cfar_1d", "shape": (512,),
             "params": dict(num_train=6, num_guard=3, rho=0.5, alpha=2.0)},
            {"name": "ca_cfar_2d", "op": "ca_cfar_2d", "shape": (128, 40),
             "params": dict(num_train=(4, 3), num_guard=(2, 1), pfa=1e-3)},
            {"name": "os_cfar_2d_detect", "op": "os_cfar_2d_detect", "shape": (64, 48),
             "params": FLAGSHIP_CFAR},
        ],
        "zoom": {"rows": 3, "n": 512, "params": ZOOM_PARAMS},
        "beamformer": {"ns": 63, "elements": 32, "angles": 24},
        # 4 antennas: the JAX package's Capon at 12 takes 12 s to compile on the CPU
        "capon": {"shape": (6, 4, 64), "angles": 48, "loading": 1e-2},
        "feed": {"frames": 16, "frame_shape": (2, 8, 12), "global_batch": 8, "pipeline": False,
                 "dir": feed_dir},
        "scaling": {"per_device_batch": 1, "iters": 1, "repeats": 1},
        "time_pipeline": 0,
    }


def full_spec(world: int, feed_dir: str) -> Dict:
    """The card's sizes: the flagship at a global batch of 1024, full-width maps and apertures.

    ``feed_dir``: where the feed's recording is written
    (:func:`.scaling.write_feed_frames` of ``feed["frames"]`` frames).
    """
    flagship_shape = (4, 63, 210)
    return {
        "pipeline": {"kind": "combined", "batch": 1024, "frames": "normal", "max_dets": 128},
        "halo": [
            # the largest map of a shipped config, at the flagship CFAR geometry
            {"name": "os_cfar_2d_detect", "op": "os_cfar_2d_detect", "shape": (64, 256, 192),
             "params": FLAGSHIP_CFAR},
            {"name": "ca_cfar_2d", "op": "ca_cfar_2d", "shape": (64, 256, 192),
             "params": dict(num_train=(5, 5), num_guard=(3, 2), pfa=1e-3)},
            # the JAX scaling harness's shape: 64 rows a rank x 128 columns
            {"name": "os_cfar_2d_detect (scaling shape)", "op": "os_cfar_2d_detect",
             "shape": (64 * world, 128),
             "params": dict(num_train=(4, 3), num_guard=(2, 1), rho=0.7, alpha=4.0)},
            # 512 cells a rank, 1024 signals
            {"name": "os_cfar_1d", "op": "os_cfar_1d", "shape": (1024, 512 * world),
             "params": dict(num_train=4, num_guard=2, rho=0.5, alpha=2.0)},
        ],
        "zoom": {"rows": 1024, "n": 8192, "params": dict(ZOOM_PARAMS, m=64)},
        # 1024 frames x 70 loops of elements
        "beamformer": {"ns": 63, "elements": 71680, "angles": 64},
        # 128 frames x 63 range bins, 12 antennas, 64 snapshots a rank
        "capon": {"shape": (8064, 12, 64 * world), "angles": 64, "loading": 1e-2},
        "feed": {"frames": 4096, "frame_shape": flagship_shape, "global_batch": 1024,
                 "pipeline": True, "dir": feed_dir},
        "scaling": {"per_device_batch": 64, "iters": 5, "repeats": 3},
        "time_pipeline": 20,
    }


# --------------------------------------------------------------------------- #
# the parent: inputs, the unsharded ops, the shards put together
# --------------------------------------------------------------------------- #
def write_inputs(root: str, spec: Dict, seed: int = 0) -> Dict[str, np.ndarray]:
    """Every global input of ``spec`` from ``seed``, saved as ``root/<name>.npy``; returns them.

    The feed's recording is written apart (:func:`.scaling.write_feed_frames`).
    """
    from mmwave_radar_processing_tpu_torch.utils.verify import make_inputs

    rng = np.random.default_rng(seed)
    cfg = flagship_config()
    arrays: Dict[str, np.ndarray] = {}
    pipe = spec["pipeline"]
    b = pipe["batch"]
    if pipe["frames"] == "simulated":
        raw_re, raw_im, alt = make_inputs(cfg, b, seed=7)
    else:
        shape = (b, cfg.num_rx_antennas, cfg.num_adc_samples, cfg.chirps_per_frame)
        raw_re, raw_im = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        alt = np.full(b, 1.2, np.float32)
    arrays.update(raw_re=raw_re, raw_im=raw_im, altitude=alt)
    if pipe["kind"] == "combined":
        arrays["gumbel"] = rng.gumbel(size=(b,) + RANSAC_DRAWS).astype(np.float32)
    for case in spec["halo"]:
        arrays[case["name"]] = rng.exponential(1.0, case["shape"]).astype(np.float32)
    z = spec["zoom"]
    arrays["zoom"] = (rng.standard_normal((z["rows"], z["n"]))
                      + 1j * rng.standard_normal((z["rows"], z["n"]))).astype(np.complex64)
    bfm = spec["beamformer"]
    ns, e, a = bfm["ns"], bfm["elements"], bfm["angles"]
    arrays["bf_data"] = (rng.standard_normal((ns, e))
                         + 1j * rng.standard_normal((ns, e))).astype(np.complex64)
    arrays["bf_positions"] = (rng.standard_normal((3, e)) * 0.01).astype(np.float32)
    theta = np.linspace(-0.5, 0.5, a)
    arrays["bf_steering"] = np.stack([np.cos(theta), np.sin(theta), np.zeros_like(theta)],
                                     axis=1).astype(np.float32)
    shape = spec["capon"]["shape"]
    arrays["snapshots"] = (rng.standard_normal(shape)
                           + 1j * rng.standard_normal(shape)).astype(np.complex64)
    for name, arr in arrays.items():
        np.save(os.path.join(root, f"{name}.npy"), arr)
    return arrays


def build_pipeline(spec: Dict, device):
    """The pipeline of ``spec`` on ``device``: point cloud or combined, flagship CFAR."""
    from mmwave_radar_processing_tpu_torch.parallel.full_pipeline import build_full_pipeline
    from mmwave_radar_processing_tpu_torch.parallel.pipeline import build_point_cloud_pipeline

    pipe = spec["pipeline"]
    build = build_full_pipeline if pipe["kind"] == "combined" else build_point_cloud_pipeline
    return build(flagship_config(), cfar_params=FLAGSHIP_CFAR, max_dets=pipe["max_dets"],
                 device=device)


def pipeline_outputs(spec: Dict, out) -> Dict[str, np.ndarray]:
    """The pipeline's outputs by name, numpy: ``pipeline/points`` and so on."""
    if spec["pipeline"]["kind"] == "combined":
        pc, vel = out
        fields = {**pc._asdict(), **vel._asdict()}
    else:
        fields = out._asdict()
    return {f"pipeline/{k}": v.detach().cpu().numpy() for k, v in fields.items()}


def pipeline_args(spec: Dict, arrays: Dict, sl: slice, device):
    """``(args, kwargs)`` of the pipeline for frames ``sl`` of the global batch."""
    def t(name):
        return torch.from_numpy(np.array(arrays[name][sl])).to(device)

    if spec["pipeline"]["kind"] == "combined":
        return (t("raw_re"), t("raw_im"), t("altitude")), {"gumbel": t("gumbel")}
    return (t("raw_re"), t("raw_im")), {}


def unsharded(spec: Dict, arrays: Dict, device) -> Dict[str, np.ndarray]:
    """The port's unsharded ops on the whole inputs, on ``device``: what the shards must give."""
    from mmwave_radar_processing_tpu_torch.ops import beamform as bf, cfar, windows, zoom_fir
    from mmwave_radar_processing_tpu_torch.processors.synthetic_array import beamform

    device = torch.device(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    args, kwargs = pipeline_args(spec, arrays, slice(None), device)
    out = pipeline_outputs(spec, build_pipeline(spec, device)(*args, **kwargs))
    for case in spec["halo"]:
        x, p = t(arrays[case["name"]]), case["params"]
        if case["op"] == "os_cfar_1d":
            got = cfar.os_1d(x, **p)[0]
        elif case["op"] == "ca_cfar_2d":
            got = cfar.ca_2d(x, **p)[0]
        else:
            got = cfar.os_2d_detect(x, **p)
        out[case["name"]] = got.cpu().numpy()
    out["zoom"] = zoom_fir.zoom_fft_fir(t(arrays["zoom"]), **spec["zoom"]["params"]).cpu().numpy()
    ns, e = arrays["bf_data"].shape
    out["beamformer"] = beamform(
        t(arrays["bf_data"]), t(arrays["bf_positions"]), t(arrays["bf_steering"]),
        flagship_config().lambda_m, t(windows.hanning(ns)), t(windows.hamming(e))).cpu().numpy()
    snaps = t(arrays["snapshots"])
    steering = capon_steering(spec).to(device)
    r = bf.spatial_covariance(snaps)
    out["capon"] = bf.capon_from_covariance(r, steering, loading=spec["capon"]["loading"]
                                            ).cpu().numpy()
    out["bartlett"] = bf.bartlett_from_covariance(r, steering).cpu().numpy()
    synchronize(device)
    return out


def capon_steering(spec: Dict) -> torch.Tensor:
    from mmwave_radar_processing_tpu_torch.ops import beamform as bf

    c = spec["capon"]
    return bf.steering_ula(grids.phase_shift_bins(c["angles"]), c["shape"][1])


#: the checks whose output is the same on every rank
REPLICATED = ("zoom", "beamformer", "capon", "bartlett")


def assemble(spec: Dict, ranks: List[Dict]) -> Dict[str, np.ndarray]:
    """The ranks' local outputs put together in rank order.

    Frame-sharded outputs are concatenated along the frames, the halo CFARs
    along their split axis (the last for 1D, the rows for 2D); a replicated
    output (zoom, beamformer, Capon, Bartlett) must be equal on every rank,
    bit for bit, and is taken once.
    """
    split = {case["name"]: -1 if case["op"] == "os_cfar_1d" else -2 for case in spec["halo"]}
    out = {}
    for name in ranks[0]["outputs"]:
        parts = [r["outputs"][name] for r in ranks]
        if name in REPLICATED:
            for r, part in enumerate(parts[1:], 1):
                if not np.array_equal(part, parts[0]):
                    raise AssertionError(f"{name}: rank {r}'s replica differs from rank 0's")
            out[name] = parts[0]
        else:
            out[name] = np.concatenate(parts, axis=split.get(name, 0))
    return out


# --------------------------------------------------------------------------- #
# the rank
# --------------------------------------------------------------------------- #
def _error(fn):
    """The message of the ``ValueError`` that ``fn`` raises, or ``None`` if it raises none."""
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return None


def _check_errors(device, world: int) -> Dict[str, str]:
    """The builders' errors, each at a size that raises at every world size."""
    from mmwave_radar_processing_tpu_torch.parallel.halo_cfar import ca_cfar_2d_row_sharded
    from mmwave_radar_processing_tpu_torch.parallel.mesh import make_mesh
    from mmwave_radar_processing_tpu_torch.parallel.overlap_save import build_sharded_zoom_fir
    from mmwave_radar_processing_tpu_torch.parallel.sharded_beamform import (
        build_sharded_beamformer, build_snapshot_sharded_capon,
    )

    mesh = make_mesh({"data": world}, device_type=device.type)
    zoom = dict(f_center=0.0, fs=2.0, num_taps=33, m=8, f1=-0.1, f2=0.1, axis="data")
    small_shards = build_sharded_zoom_fir(mesh, n=16 * world, decim=4, **zoom)
    cfar = ca_cfar_2d_row_sharded(mesh, num_train=(7, 3), num_guard=(3, 1), pfa=1e-3)
    return {
        "halo_rows_per_shard": _error(lambda: cfar(torch.ones((8, 24), device=device))),
        "zoom_decim": _error(lambda: build_sharded_zoom_fir(mesh, n=10 * world, decim=4,
                                                            **zoom)),
        "zoom_samples_per_shard": _error(lambda: small_shards(
            torch.ones((2, 16), dtype=torch.complex64, device=device))),
        # n = 17 at world 1 divides over its one shard: no error there
        "zoom_n_divides": _error(lambda: build_sharded_zoom_fir(mesh, n=16 * world + 1,
                                                                decim=1, **zoom)),
        "mesh_two_unknown": _error(lambda: make_mesh({"data": -1, "model": -1},
                                                     device_type=device.type)),
        "mesh_wrong_size": _error(lambda: make_mesh({"data": world + 1},
                                                    device_type=device.type)),
        "split_complex": _error(lambda: build_sharded_beamformer(mesh, lambda_m=0.005,
                                                                 split_complex=True)),
        "capon_method": _error(lambda: build_snapshot_sharded_capon(mesh, method="music")),
    }


def _check_feed(device, feed: Dict, spec: Dict) -> Dict:
    """The feed over the recording: this rank's frames, each batch against a straight load."""
    from mmwave_radar_processing_tpu_torch.data.native_loader import load_frames_split
    from mmwave_radar_processing_tpu_torch.parallel.input_feed import (
        process_local_frame_slice, sharded_recording_feed,
    )
    from mmwave_radar_processing_tpu_torch.parallel.mesh import make_mesh
    from mmwave_radar_processing_tpu_torch.parallel.pipeline import shard_pipeline

    world = dist.get_world_size()
    model = 2 if world % 2 == 0 else 1
    mesh = make_mesh({"data": world // model, "model": model}, device_type=device.type)
    gb = feed["global_batch"]
    share = process_local_frame_slice(mesh, gb, "data")
    paths = frame_paths(feed["dir"], feed["frames"])
    pipe = None
    if feed["pipeline"]:
        pipe = shard_pipeline(build_pipeline(spec, device), mesh)

    def run():
        batches, outputs_finite = [], True
        for re, im, alt in sharded_recording_feed(mesh, paths, feed["frame_shape"],
                                                  global_batch=gb, altitude=0.7, device=device):
            batches.append((re, im, alt))
            if pipe is not None:
                pc, vel = pipe(re, im, alt, global_batch=gb)
                outputs_finite &= bool(torch.isfinite(pc.points).all()
                                       and torch.isfinite(vel.velocity).all())
        return batches, outputs_finite

    synchronize(device)
    t0 = time.perf_counter()
    (batches, outputs_finite), launches = count_launches(run)
    seconds = time.perf_counter() - t0
    # every batch taken before any is compared: a slot refilled under a
    # batch still in use would show here
    equal = []
    for b, (re, im, alt) in enumerate(batches):
        mine = [p for p in paths[b * gb:(b + 1) * gb]][share]
        want_re, want_im = load_frames_split(mine, feed["frame_shape"], backend="numpy")
        equal.append(bool(torch.equal(re.cpu(), want_re) and torch.equal(im.cpu(), want_im)
                          and bool((alt.cpu() == np.float32(0.7)).all())
                          and re.device == device))
    return {"share": (share.start, share.stop), "batches": len(batches), "equal": equal,
            "frames": sum(int(r.shape[0]) for r, _, _ in batches), "seconds": seconds,
            "outputs_finite": outputs_finite, "launches": launches,
            "coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model"))}


def run_rank(device: torch.device, root: str, spec: Dict) -> Dict:
    """One rank of the checks: its outputs, launches, errors, feed, dry run and scaling figures."""
    from mmwave_radar_processing_tpu_torch.ops import windows
    from mmwave_radar_processing_tpu_torch.parallel import halo_cfar
    from mmwave_radar_processing_tpu_torch.parallel.mesh import make_mesh
    from mmwave_radar_processing_tpu_torch.parallel.overlap_save import build_sharded_zoom_fir
    from mmwave_radar_processing_tpu_torch.parallel.pipeline import shard_pipeline
    from mmwave_radar_processing_tpu_torch.parallel.scaling import scaling_rank, time_calls
    from mmwave_radar_processing_tpu_torch.parallel.sharded_beamform import (
        build_sharded_beamformer, build_snapshot_sharded_capon,
    )

    world, rank = dist.get_world_size(), dist.get_rank()
    data = make_mesh({"data": world}, device_type=device.type)
    model = make_mesh({"model": world}, device_type=device.type)
    arrays = {name: np.load(os.path.join(root, f"{name}.npy"), mmap_mode="r")
              for name in ("raw_re", "raw_im", "altitude", "gumbel", "zoom", "bf_data",
                           "bf_positions", "bf_steering", "snapshots",
                           *(c["name"] for c in spec["halo"]))
              if os.path.exists(os.path.join(root, f"{name}.npy"))}

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    outputs, launches, seconds = {}, {}, {}

    # frame-parallel pipeline
    b = spec["pipeline"]["batch"]
    frames = frame_slice(data, b, "data")
    pipeline = build_pipeline(spec, device)
    sharded = shard_pipeline(pipeline, data)
    args, kwargs = pipeline_args(spec, arrays, frames, device)
    out, launches["pipeline"] = count_launches(
        lambda: sharded(*args, global_batch=b, **kwargs))
    outputs.update(pipeline_outputs(spec, out))
    if spec["time_pipeline"]:
        # the wrapper's overhead: the sharded call beside the bare pipeline on the same frames
        seconds["pipeline_sharded"] = time_calls(
            lambda: sharded(*args, global_batch=b, **kwargs), spec["time_pipeline"], 3, device)
        seconds["pipeline_bare"] = time_calls(lambda: pipeline(*args, **kwargs),
                                              spec["time_pipeline"], 3, device)

    # halo CFARs: 1D over the last axis, 2D over the rows
    builders = {"os_cfar_1d": halo_cfar.os_cfar_1d_sharded,
                "ca_cfar_2d": halo_cfar.ca_cfar_2d_row_sharded,
                "os_cfar_2d_detect": halo_cfar.os_cfar_2d_detect_row_sharded}
    for case in spec["halo"]:
        x = arrays[case["name"]]
        dim = -1 if case["op"] == "os_cfar_1d" else -2
        sl = [slice(None)] * x.ndim
        sl[dim] = frame_slice(data, x.shape[dim], "data")
        fn = builders[case["op"]](data, axis="data", **case["params"])
        local = t(x[tuple(sl)])
        got, launches[case["name"]] = count_launches(lambda: fn(local))
        outputs[case["name"]] = got.cpu().numpy()

    # overlap-save zoom, samples over data
    z = spec["zoom"]
    zoom = build_sharded_zoom_fir(data, n=z["n"], axis="data", **z["params"])
    local = t(arrays["zoom"][:, frame_slice(data, z["n"], "data")])
    got, launches["zoom"] = count_launches(lambda: zoom(local))
    outputs["zoom"] = got.cpu().numpy()

    # element-sharded beamformer and snapshot-sharded Capon / Bartlett, over model
    ns, e = arrays["bf_data"].shape
    elems = frame_slice(model, e, "model")
    beam = build_sharded_beamformer(model, lambda_m=flagship_config().lambda_m)
    bf_args = (t(arrays["bf_data"][:, elems]), t(arrays["bf_positions"][:, elems]),
               t(arrays["bf_steering"]), t(windows.hanning(ns)), t(windows.hamming(e)[elems]))
    got, launches["beamformer"] = count_launches(lambda: beam(*bf_args))
    outputs["beamformer"] = got.cpu().numpy()
    snaps = t(arrays["snapshots"][..., frame_slice(model, arrays["snapshots"].shape[-1],
                                                   "model")])
    steering = capon_steering(spec).to(device)
    for method in ("capon", "bartlett"):
        fn = build_snapshot_sharded_capon(model, loading=spec["capon"]["loading"],
                                          method=method)
        got, launches[method] = count_launches(lambda: fn(snaps, steering))
        outputs[method] = got.cpu().numpy()

    result = {"rank": rank, "world": world, "backend": dist.get_backend(),
              "device": str(device), "outputs": outputs, "launches": launches,
              "seconds": seconds}
    result["feed"] = _check_feed(device, spec["feed"], spec)
    result["errors"] = _check_errors(device, world)
    result["dryrun"] = dryrun_rank(device)
    cfg = flagship_config()
    # flagship frames of the scaling harness's own, one set a rank
    frame_shape = (cfg.num_rx_antennas, cfg.num_adc_samples, cfg.chirps_per_frame)
    paths = write_feed_frames(os.path.join(root, f"scaling_frames_rank{rank}"), frame_shape)
    s = spec["scaling"]
    result["scaling"] = scaling_rank(device, cfg, s["per_device_batch"], s["iters"],
                                     s["repeats"], paths)
    return result
