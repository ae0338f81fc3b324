"""Precompute-then-scrub playback: batched device payloads behind the viewer (JAX: ``visualization/precompute.py``).

:class:`PrecomputedPlayback` runs a whole recording through
:func:`parallel.viewer_pipeline.build_viewer_payload_pipeline` (plus the
Capon pipeline, the DBS stage and the ground scan for the stateful
altimeter and ground detector) in a few batched calls on the controller's
device, caches the per-frame payload arrays on the host, and serves them to
the controller during playback and scrubbing: the processing leg of a tick
becomes a dict lookup.

Semantics: cached payloads represent sequential playback from frame 0
(what ``controller.play()`` produces).  For the stateful processors
(micro-Doppler history, altimeter track) a scrub to frame ``i`` shows the
state as if frames ``0..i`` had played in order.

Coverage: the registry keys in ``COVERED``.  A key whose YAML parameters
use what the batched pipelines do not implement (a custom ``range_window``
for Doppler-azimuth, ``rx_idx=-1``, ...) is dropped from coverage and falls
back to the per-frame path: the result stays the same, only the speed
differs.  The decisions are the JAX package's, for the same YAML.

Every chunk of every pipeline is launched before the first copy to the
host; each leaf is then copied once, in its own dtype.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional, Set

import numpy as np
import torch

from mmwave_radar_processing_tpu_torch.utils.logger import get_logger

#: registry keys the batched device pipelines can serve
COVERED = frozenset({
    "range_doppler_resp",
    "range_resp",
    "micro_doppler_resp",
    "doppler_azimuth_resp",
    "range_angle_resp",
    "range_detector",
    "range_doppler_detector_2d",
    "range_doppler_detector_sequential",
    "range_doppler_ground_detector",
    "point_cloud_generator",
    "altimeter",
    "capon_beamformer",
    "bartlett_beamformer",
    "range_angle_resp_dbs_enhanced",
})

#: viewer-pipeline output group needed per key (None = separate pipeline)
_INCLUDE_GROUP = {
    "micro_doppler_resp": "md",
    "doppler_azimuth_resp": "da",
    "range_angle_resp": "ra",
    "range_detector": "det1d",
    "range_doppler_detector_2d": "det2d",
    "range_doppler_detector_sequential": "detseq",
    "point_cloud_generator": "det2d",
}

#: per-key process()/ctor kwargs the batched pipeline honors; any other
#: YAML-provided kwarg drops the key back to the per-frame path
_SUPPORTED_PARAMS = {
    "range_doppler_resp": {"rx_idx"},
    "range_resp": {"chirp_idx"},  # chirp 0 only (the default)
    "micro_doppler_resp": {"rx_idx", "target_ranges", "num_frames_history"},
    "doppler_azimuth_resp": {"num_angle_bins", "valid_angle_range",
                             "rx_antennas"},
    "range_doppler_detector_2d": {"cfar_type", "cfar_params"},
    "point_cloud_generator": {
        "az_antenna_idxs", "el_antenna_idxs", "detector_type",
        "detector_params", "shift_az_resp", "shift_el_resp", "num_angle_bins",
    },
    "altimeter": {"min_altitude_m", "zoom_search_region_m",
                  "altitude_search_limit_m", "range_bias"},
    "range_angle_resp": {"num_angle_bins", "chirp_idx", "rx_antennas",
                         "perform_windowing"},
    "range_detector": {"cfar_type", "cfar_params", "max_dets"},
    "range_doppler_detector_sequential": {
        "rng_cfar_type", "rng_cfar_params", "vel_cfar_type",
        "vel_cfar_params"},
    "range_doppler_ground_detector": {
        "vel_cfar_type", "vel_cfar_params", "altimeter_params"},
    "capon_beamformer": {"antenna_idxs", "num_angle_bins",
                         "diagonal_loading"},
    "bartlett_beamformer": {"antenna_idxs", "num_angle_bins",
                            "diagonal_loading"},
    "range_angle_resp_dbs_enhanced": {
        "num_angle_bins_range_angle_response",
        "num_angle_bins_dbs_enhanced_response", "min_x_y_vel_dbs",
        "rx_antennas"},
}

#: what reading a recording's odometry may raise; any other error (a CUDA
#: fault, a bug) propagates instead of being taken for missing odometry
_DATASET_ERRORS = (OSError, IndexError, ValueError, KeyError)


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PrecomputedPlayback:
    """Recording-wide payload cache built from the batched device pipelines.

    Args:
        controller: a loaded ``MmWaveRadarProcessorController`` (dataset,
            config and processors initialized); the pipelines run on its
            device.
        keys: registry keys to precompute (default: every enabled processor
            key in ``COVERED``).
        batch_size: frames per call of the stateless pipelines.
    """

    def __init__(self, controller, keys: Optional[Iterable[str]] = None,
                 batch_size: int = 64):
        self.logger = get_logger(__name__)
        self.controller = controller
        self.device = controller.device
        self.batch_size = int(batch_size)
        self.cfg = controller.config_model.config
        if self.cfg is None:
            raise ValueError("controller has no config loaded")
        want = set(keys) if keys is not None else set(controller.processors)
        self._keys: Set[str] = set()
        self._params: Dict[str, dict] = {}
        for key in want & COVERED & set(controller.processors):
            params = dict(controller.processor_params.get(key, {}))
            unsupported = set(params) - _SUPPORTED_PARAMS.get(key, set())
            if unsupported:
                self.logger.info(
                    "precompute: %s falls back to per-frame (unsupported "
                    "params %s)", key, sorted(unsupported))
                continue
            if int(params.get("rx_idx", 0)) < 0:
                continue  # rx_idx=-1 (all antennas) stays per-frame
            if (key in ("range_resp", "range_angle_resp")
                    and int(params.get("chirp_idx", 0)) != 0):
                continue  # non-default chirp stays per-frame
            if (key == "range_angle_resp"
                    and not params.get("perform_windowing", True)):
                continue
            self._keys.add(key)
            self._params[key] = params
        self._arrays: Dict[str, np.ndarray] = {}
        self._dbs_meta = None
        self.num_frames = 0
        self.build_seconds: Optional[float] = None
        #: seconds of the last build: reading the recording, the device work
        #: (launches to the last result), and the copies to the host
        self.build_split: Dict[str, float] = {}

    # ------------------------------------------------------------------ #
    def covers(self, key: str) -> bool:
        return key in self._keys and bool(self._arrays)

    @property
    def covered_keys(self) -> Set[str]:
        return set(self._keys)

    def _payload_kwargs(self) -> dict:
        """The payload pipeline's keywords for the covered keys (drops keys it cannot share)."""
        kw = {}
        p = self._params
        if "range_doppler_resp" in p or "micro_doppler_resp" in p:
            rx_rd = int(p.get("range_doppler_resp", {}).get("rx_idx", 0))
            rx_md = int(p.get("micro_doppler_resp", {}).get("rx_idx", 0))
            if ("range_doppler_resp" in p and "micro_doppler_resp" in p
                    and rx_rd != rx_md):
                # one shared channel per build; the rarer consumer falls back
                self._keys.discard("micro_doppler_resp")
            kw["rx_idx"] = rx_rd if "range_doppler_resp" in p else rx_md
        if "micro_doppler_resp" in p:
            kw["md_target_ranges"] = tuple(
                p["micro_doppler_resp"].get("target_ranges", (0.0, 1.0)))
        if "doppler_azimuth_resp" in p:
            da = p["doppler_azimuth_resp"]
            kw["num_angle_bins"] = int(da.get("num_angle_bins", 64))
            if "valid_angle_range" in da:
                kw["valid_angle_range"] = tuple(da["valid_angle_range"])
            if da.get("rx_antennas"):
                kw["da_rx_antennas"] = tuple(da["rx_antennas"])
        if "range_doppler_detector_2d" in p:
            det = p["range_doppler_detector_2d"]
            kw["cfar_type"] = det.get("cfar_type", "ca_cfar_2d")
            if det.get("cfar_params"):
                kw["cfar_params"] = dict(det["cfar_params"])
        if "point_cloud_generator" in p:
            pc = p["point_cloud_generator"]
            if int(pc.get("num_angle_bins", 64)) != int(
                    kw.get("num_angle_bins", 64)):
                # the payload pipeline shares one angle grid between DA and AoA
                self._keys.discard("point_cloud_generator")
                pc = {}
            for name in ("az_antenna_idxs", "el_antenna_idxs"):
                if name in pc:
                    kw[name] = tuple(pc[name])
            for name in ("shift_az_resp", "shift_el_resp"):
                if name in pc:
                    kw[name] = bool(pc[name])
            dp = pc.get("detector_params") or {}
            if pc.get("detector_type",
                      "range_doppler_detector_2d") != "range_doppler_detector_2d":
                self._keys.discard("point_cloud_generator")
            elif dp:
                kw["cfar_type"] = dp.get("cfar_type", "ca_cfar_2d")
                if dp.get("cfar_params"):
                    kw["cfar_params"] = dict(dp["cfar_params"])

        if "range_angle_resp" in p:
            ra = p["range_angle_resp"]
            kw["ra_num_angle_bins"] = int(ra.get("num_angle_bins", 64))
            if ra.get("rx_antennas"):
                kw["ra_rx_antennas"] = tuple(ra["rx_antennas"])
        if "range_detector" in p:
            rd1 = p["range_detector"]
            kw["cfar1d_type"] = rd1.get("cfar_type", "os_cfar_1d")
            if rd1.get("cfar_params"):
                kw["cfar1d_params"] = dict(rd1["cfar_params"])
            kw["max_dets_1d"] = int(rd1.get("max_dets", 64))
        if "range_doppler_detector_sequential" in p:
            sq = p["range_doppler_detector_sequential"]
            if sq.get("rng_cfar_type") or sq.get("rng_cfar_params"):
                kw["seq_rng_cfar"] = (
                    sq.get("rng_cfar_type", "os_cfar_1d"),
                    dict(sq.get("rng_cfar_params")
                         or dict(num_train=5, num_guard=3, rho=0.6, alpha=2)))
            if sq.get("vel_cfar_type") or sq.get("vel_cfar_params"):
                kw["seq_vel_cfar"] = (
                    sq.get("vel_cfar_type", "os_cfar_1d"),
                    dict(sq.get("vel_cfar_params")
                         or dict(num_train=5, num_guard=2, rho=0.7, alpha=3)))
        if int(kw.get("rx_idx", 0)) != 0:
            # every detector's RD magnitude map is fixed to antenna 0; the
            # shared rd_map here follows rx_idx, so a non-zero rx_idx drops
            # the detector keys
            for k in ("range_doppler_detector_2d", "point_cloud_generator",
                      "range_doppler_detector_sequential",
                      "range_doppler_ground_detector"):
                self._keys.discard(k)
        kw["include"] = sorted(
            {_INCLUDE_GROUP[k] for k in self._keys if k in _INCLUDE_GROUP})
        caps = [self._capacity(k) for k in ("range_doppler_detector_2d",
                                            "range_doppler_detector_sequential",
                                            "point_cloud_generator") if k in self._keys]
        if caps:
            kw["max_dets"] = max(caps)
        return kw

    def _capacity(self, key: str) -> int:
        """The detection capacity of ``key``'s live per-frame processor (its detector's, for the point cloud).

        The cache keeps as many detections a frame as the per-frame path
        does (the JAX package's cache keeps 128 where its detectors keep 256,
        and so drops detections of a dense frame).
        """
        proc = self.controller.processors[key]
        return int(getattr(proc, "detector", proc).max_dets)

    def _chunks(self, fn, *planes):
        """``fn`` over consecutive chunks of ``batch_size`` frames; the results, launched, not waited on."""
        n = planes[0].shape[0]
        return [fn(*(x[lo:lo + self.batch_size] for x in planes))
                for lo in range(0, n, self.batch_size)]

    def _altitude_track(self, params: dict, raw_re, raw_im, **extra) -> torch.Tensor:
        """The ground scan's altitude track ``[T]`` over the whole recording."""
        from mmwave_radar_processing_tpu_torch.parallel.ground_pipeline import (
            build_ground_point_cloud_pipeline,
        )

        alt_fn = build_ground_point_cloud_pipeline(
            self.cfg,
            min_altitude_m=float(params.get("min_altitude_m", 0.25)),
            zoom_search_region_m=float(params.get("zoom_search_region_m", 0.2)),
            altitude_search_limit_m=float(params.get("altitude_search_limit_m", 0.4)),
            range_bias=float(params.get("range_bias", 0.0)),
            stop_after="altitude", device=self.device, **extra)
        return alt_fn(raw_re, raw_im)[0].reshape(-1)

    def _read_recording(self, ds, n: int):
        """The recording as split float32 planes ``[n, rx, ns, nc]`` on the host.

        The NPY bulk loader reads the files (``data.native_loader``: on a
        CUDA controller its native version on 8 threads into pinned memory,
        on the CPU its plain version, ``np.load`` frame by frame), bit-equal
        to ``get_adc_data`` with the real and imaginary parts split.
        """
        from mmwave_radar_processing_tpu_torch.data import native_loader

        cuda = self.device.type == "cuda"
        shape = ds.get_adc_data(0).shape
        out = tuple(torch.empty((n, *shape), dtype=torch.float32, pin_memory=cuda)
                    for _ in range(2))
        return native_loader.load_frames_split(
            ds.get_adc_paths(), shape, out=out, backend="native" if cuda else "numpy")

    def build(self) -> Set[str]:
        """Run the recording through the device pipelines; cache host arrays.

        Returns the set of covered keys.
        """
        from mmwave_radar_processing_tpu_torch.parallel.viewer_pipeline import (
            build_viewer_payload_pipeline,
        )

        t0 = time.perf_counter()
        ds = self.controller.dataset_model
        n = ds.num_frames
        if n == 0:
            raise ValueError("no dataset loaded")
        raw_re, raw_im = self._read_recording(ds, n)
        vels = None
        if "range_angle_resp_dbs_enhanced" in self._keys:
            # the DBS stage needs each frame's platform velocity; without
            # odometry the key falls back to the per-frame path
            try:
                vels = torch.from_numpy(np.stack([
                    np.asarray(ds.get_velocity_ned(i), np.float32) for i in range(n)]))
            except _DATASET_ERRORS:
                self._keys.discard("range_angle_resp_dbs_enhanced")
        t_read = time.perf_counter()

        with torch.inference_mode():
            device = self.device
            raw_re = raw_re.to(device, non_blocking=True)
            raw_im = raw_im.to(device, non_blocking=True)
            fn = build_viewer_payload_pipeline(self.cfg, device=device,
                                               **self._payload_kwargs())
            dev: Dict[str, list] = {}
            for out in self._chunks(fn, raw_re, raw_im):
                for k, v in out.items():
                    dev.setdefault(k, []).append(v)
            dev = {k: torch.cat(v) for k, v in dev.items()}

            for bkey, method in (("capon_beamformer", "capon"),
                                 ("bartlett_beamformer", "bartlett")):
                if bkey not in self._keys:
                    continue
                from mmwave_radar_processing_tpu_torch.parallel.capon_pipeline import (
                    build_capon_pipeline,
                )

                bp = self._params[bkey]
                idxs = bp.get("antenna_idxs")
                if idxs is None:
                    idxs = tuple(range(
                        self.cfg.num_virtual_antennas
                        if self.cfg.virtual_antennas_enabled
                        else self.cfg.num_rx_antennas))
                bfn = build_capon_pipeline(
                    self.cfg, antenna_idxs=tuple(idxs),
                    num_angle_bins=int(bp.get("num_angle_bins", 64)),
                    method=method,
                    loading=float(bp.get("diagonal_loading", 1e-2)), device=device)
                dev[bkey] = torch.cat(self._chunks(bfn, raw_re, raw_im))

            self._dbs_meta = None
            if vels is not None:
                from mmwave_radar_processing_tpu_torch.config import grids
                from mmwave_radar_processing_tpu_torch.parallel.viewer_pipeline import (
                    build_dbs_viewer_stage,
                )

                dp = self._params["range_angle_resp_dbs_enhanced"]
                a_ra = int(dp.get("num_angle_bins_range_angle_response", 64))
                a_dbs = int(dp.get("num_angle_bins_dbs_enhanced_response", 64))
                dbs_fn = build_dbs_viewer_stage(
                    self.cfg,
                    num_angle_bins_range_angle_response=a_ra,
                    num_angle_bins_dbs_enhanced_response=a_dbs,
                    min_x_y_vel_dbs=float(dp.get("min_x_y_vel_dbs", 0.25)),
                    rx_antennas=(tuple(dp["rx_antennas"])
                                 if dp.get("rx_antennas") else None),
                    device=device)
                parts = self._chunks(dbs_fn, raw_re, raw_im, vels.to(device))
                for i, name in enumerate(("dbs_ra", "dbs_map", "dbs_use")):
                    dev[name] = torch.cat([p[i] for p in parts])
                # both branches' angle grids and meshes, picked per frame
                rb = grids.range_bins(self.cfg, variant="offset")
                coarse = grids.angle_bins(a_ra)
                fine = np.linspace(coarse[0], coarse[-1], a_dbs)
                self._dbs_meta = {
                    False: (coarse,) + grids.polar_mesh(rb, coarse)[2:],
                    True: (fine,) + grids.polar_mesh(rb, fine)[2:],
                }

            if "range_doppler_ground_detector" in self._keys:
                from mmwave_radar_processing_tpu_torch.parallel.viewer_pipeline import (
                    build_ground_detector_stage,
                )

                gp = self._params["range_doppler_ground_detector"]
                ap = dict(gp.get("altimeter_params") or {})
                precise = bool(ap.pop("precise_est_enabled", True))
                alt_track = self._altitude_track(ap, raw_re, raw_im,
                                                 precise_est_enabled=precise)
                stage = build_ground_detector_stage(
                    self.cfg, vel_cfar_type=gp.get("vel_cfar_type", "os_cfar_1d"),
                    vel_cfar_params=gp.get("vel_cfar_params"),
                    max_dets=self._capacity("range_doppler_ground_detector"), device=device)
                for name, v in zip(("detg_r", "detg_v", "detg_valid", "detg_count"),
                                   stage(dev["rd_map"], alt_track)):
                    dev[name] = v
                dev["altitude_gd"] = alt_track

            if "altimeter" in self._keys:
                dev["altitude"] = self._altitude_track(self._params["altimeter"],
                                                       raw_re, raw_im)
            del raw_re, raw_im
            _fence(device)
            t_device = time.perf_counter()
            # one copy per leaf, in its own dtype (a zero-width leaf stays so)
            self._arrays = {k: v.cpu().numpy() for k, v in dev.items()}
        t_copy = time.perf_counter()

        self.num_frames = n
        self.build_seconds = t_copy - t0
        self.build_split = {"read_s": t_read - t0, "device_s": t_device - t_read,
                            "copy_s": t_copy - t_device}
        self.logger.info(
            "precomputed %d frames for %d views in %.2fs (%.1f ms/frame)",
            n, len(self._keys), self.build_seconds,
            1e3 * self.build_seconds / max(n, 1))
        return self.covered_keys

    # ------------------------------------------------------------------ #
    def payload(self, key: str, idx: int) -> Optional[dict]:
        """Dynamic payload parts for ``key`` at frame ``idx`` (host dict).

        Returns ``None`` when the key is not covered; the controller then
        falls back to the per-frame processor.  Static ``view_keys``
        attributes (bin grids) are filled in by the controller from the live
        processor, so the bins equal the per-frame path's.
        """
        if not self.covers(key) or not (0 <= idx < self.num_frames):
            return None
        a = self._arrays
        if key == "range_doppler_resp":
            return {"data": a["rd_map"][idx]}
        if key == "range_resp":
            return {"data": a["range_profile"][idx]}
        if key == "micro_doppler_resp":
            proc = self.controller.processors.get(key)
            hist = int(getattr(proc, "num_frames_history", 20))
            nvel = a["md_col"].shape[1]
            data = np.zeros((nvel, hist), np.float32)
            take = min(hist, idx + 1)
            # newest column first (the processor's shift-register order)
            data[:, :take] = a["md_col"][idx - take + 1: idx + 1][::-1].T
            return {"data": data}
        if key == "doppler_azimuth_resp":
            return {"data": a["da_map"][idx]}
        if key == "range_doppler_detector_2d":
            valid = a["det_valid"][idx]
            dets = np.stack([a["det_r"][idx][valid], a["det_v"][idx][valid]],
                            axis=1).astype(int)
            return {"data": dets, "rng_dop_resp": a["rd_map"][idx]}
        if key == "point_cloud_generator":
            valid = a["pt_valid"][idx]
            return {"data": a["points"][idx][valid]}
        if key == "altimeter":
            return {"data": np.asarray(a["altitude"][idx]),
                    "coarse_fft_data": a["range_profile"][idx]}
        if key == "range_angle_resp":
            return {"data": a["ra_map"][idx]}
        if key == "range_detector":
            valid = a["det1d_valid"][idx]
            return {"data": a["det1d_idx"][idx][valid].astype(int),
                    "range_resp": a["range_profile"][idx],
                    "thresholds": a["det1d_thr"][idx]}
        if key in ("capon_beamformer", "bartlett_beamformer"):
            return {"data": a[key][idx]}
        if key == "range_doppler_detector_sequential":
            valid = a["detseq_valid"][idx]
            dets = np.stack([a["detseq_r"][idx][valid],
                             a["detseq_v"][idx][valid]], axis=1).astype(int)
            return {"data": dets, "rng_dop_resp": a["rd_map"][idx]}
        if key == "range_doppler_ground_detector":
            valid = a["detg_valid"][idx]
            dets = np.stack([a["detg_r"][idx][valid],
                             a["detg_v"][idx][valid]], axis=1).astype(int)
            return {"data": dets, "rng_dop_resp": a["rd_map"][idx]}
        if key == "range_angle_resp_dbs_enhanced":
            # the speed gate picks the map the per-frame processor would have
            # produced, and its bin grid and mesh ride along (the live
            # processor's attributes reflect only the last frame processed)
            use = bool(a["dbs_use"][idx])
            bins, x_s, y_s = self._dbs_meta[use]
            return {"data": a["dbs_map" if use else "dbs_ra"][idx],
                    "angle_bins": bins, "x_s": x_s, "y_s": y_s}
        return None
