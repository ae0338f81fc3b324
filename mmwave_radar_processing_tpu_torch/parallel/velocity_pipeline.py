"""Frame-batched ego-velocity pipeline (JAX: ``parallel/velocity_pipeline.py``).

Raw ADC cubes and altitudes in, gated ``[az_vy, el_vy, vx]`` estimates and
their fit statistics out: the ODS ADC path of the RadVel velocity estimator.
Per frame:

1. the altitude window: ``W`` range rows starting where the range grid
   first reaches ``altitude - lower_range_bound``, and the mask of the rows
   within ``[altitude - lower, altitude + upper]``;
2. the windowed range DFT of the ``W`` rows only, with the virtual-array
   reformat folded in (a per-frame DFT matrix, built in float32 as the JAX
   package builds it);
3. the chirp (Doppler) DFT of all 12 virtual channels;
4. the Doppler-azimuth responses of the two azimuth and the two elevation
   4-antenna sub-arrays (the hand-written CUDA kernel on a GPU), each pair
   averaged;
5. ``vx`` from the strongest zero-azimuth Doppler peak of each response;
6. with ``enable_precise``: the responses again on a zoomed two-half-band
   velocity grid centred at ``-vx``, and ``vx`` read again from it;
7. per velocity row the highest prominent angle peak, and one RANSAC ``vy``
   fit per response (the standard model for ``vx >= 0.1``, the inverted
   small-``vx`` model otherwise);
8. R^2 and inlier-fraction gates.

Under ``torch.profiler`` a call is the span ``mmw.vel``, split into
``mmw.vel.window_dft`` (1-3), ``mmw.vel.responses`` (4), ``mmw.vel.vx`` (5),
``mmw.vel.precise`` (6, with its own ``mmw.vel.responses`` inside),
``mmw.vel.peaks`` and ``mmw.vel.ransac`` (7-8).

RANSAC samples with Gumbel scores ``[B, 2, 20, n]`` (``n`` velocity rows,
azimuth fit first).  ``forward`` takes them as ``gumbel``; without them it
draws them from a generator seeded with ``seed`` at every call, so the same
input gives the same output.  The JAX package's draws cannot be reproduced
here; its tests hand them in.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mmwave_radar_processing_tpu_torch.config import RadarConfig, grids
from mmwave_radar_processing_tpu_torch.ops import dft, ransac
from mmwave_radar_processing_tpu_torch.ops.doppler_az import set_responses
from mmwave_radar_processing_tpu_torch.ops.peaks import (
    best_prominent_peak,
    local_maxima,
)
from mmwave_radar_processing_tpu_torch.parallel.pipeline import (
    resolve_device,
    set_full_fp32,
)
from mmwave_radar_processing_tpu_torch.processors.velocity_estimator import (
    ODS_AZ_SETS_VIRTUAL,
    ODS_EL_SETS_VIRTUAL,
)
from mmwave_radar_processing_tpu_torch.utils.profiling import annotate

MAX_TRIALS = 20
MIN_SAMPLES = 10
MIN_PROMINENCE_DB = 4.0
STOP_AFTER = (None, "responses", "vx", "peaks")


class VelocityBatch(NamedTuple):
    velocity: torch.Tensor  # float32 [B, 3]: gated [az_vy, el_vy, vx]
    vx: torch.Tensor  # float32 [B]: zero-azimuth readout
    az_r2: torch.Tensor  # float32 [B]
    el_r2: torch.Tensor  # float32 [B]
    az_inlier: torch.Tensor  # float32 [B]
    el_inlier: torch.Tensor  # float32 [B]


def _angle_tables(az, el, valid_cols):
    """Transposed sub-array angle factors ``[Av, 16]``: column ``s*4 + r``.

    ``az``/``el``: float32 ``[4, num_angle_bins]`` factor planes (cos or
    sin); sets 0-1 are azimuth, 2-3 elevation, each pair on one matrix.
    """
    az, el = az[:, valid_cols], el[:, valid_cols]
    return torch.stack([az, az, el, el]).reshape(-1, len(valid_cols)).T.contiguous()


def _db(resp: torch.Tensor, floor_db: float) -> torch.Tensor:
    """``20*log10(resp + 1e-12)`` clamped to ``floor_db`` below each frame's maximum."""
    db = dft.db20(resp + 1e-12)
    top = db.amax(dim=(-2, -1), keepdim=True)
    return torch.maximum(db, top - floor_db)


class VelocityPipeline(nn.Module):
    """``(raw_re, raw_im) [B, rx, ns, nc], altitude [B] -> VelocityBatch``.

    Build it with :func:`build_velocity_pipeline`, which checks the options
    and places it on a device.
    """

    def __init__(
        self,
        cfg: RadarConfig,
        *,
        lower_range_bound: float,
        upper_range_bound: float,
        num_angle_bins: int,
        valid_angle_range: Sequence[float],
        peak_threshold_db: float,
        min_r2_threshold: float,
        min_inlier_percent: float,
        enable_precise: bool,
        precise_vel_bound: float,
        min_zoom_fft_vel_span: float,
        seed: int,
        stop_after: Optional[str],
    ):
        super().__init__()
        ns, loops = cfg.num_adc_samples, cfg.frame.loops
        self.ns, self.nv = ns, loops
        self.num_rx, self.cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
        self.n_virt = self.num_rx * self.cpl
        self.frame_shape = (ns, loops * self.cpl)
        self.lower, self.upper = lower_range_bound, upper_range_bound
        self.range_max, self.range_res = cfg.range_max_m, cfg.range_res_m
        # static width of the altitude window (bins), +2 for inclusive ends
        self.win_rows = min(ns, int(np.ceil(
            (lower_range_bound + upper_range_bound) / cfg.range_res_m)) + 2)
        self.peak_threshold_db = peak_threshold_db
        self.min_r2, self.min_inlier = min_r2_threshold, min_inlier_percent
        self.enable_precise = enable_precise
        self.precise_vel_bound = precise_vel_bound
        self.min_span = min_zoom_fft_vel_span
        self.vmax = cfg.vel_max_m_s
        self.vel_fs = 1.0 / cfg.vel_res_m_s
        self.seed, self.stop_after = seed, stop_after
        self.num_angle_bins = num_angle_bins

        angle_bins = grids.angle_bins(num_angle_bins)
        var = np.asarray(valid_angle_range, float)
        valid = (angle_bins >= var[0]) & (angle_bins <= var[1])
        self.valid_cols = np.flatnonzero(valid)
        self.zero_az_col = int(np.argmin(np.abs(angle_bins[valid])))
        self.set_idx = tuple(tuple(int(c) for c in s) for s in
                             (*ODS_AZ_SETS_VIRTUAL, *ODS_EL_SETS_VIRTUAL))

        az_c, az_s = dft.aoa_factors(4, num_angle_bins, shift=True)
        el_c, el_s = dft.aoa_factors(4, num_angle_bins, shift=False)
        self.register_buffer("chirp_dft", dft.to_matrix(dft.dft_factors(
            loops, window=np.hanning(loops), shift=True)))
        self.register_buffer("fct", _angle_tables(az_c, el_c, self.valid_cols))
        self.register_buffer("fst", _angle_tables(az_s, el_s, self.valid_cols))
        self.register_buffer("range_bins", torch.from_numpy(
            grids.range_bins(cfg, variant="eps").astype(np.float32)))
        self.register_buffer("vel_bins", torch.from_numpy(
            grids.vel_bins(cfg).astype(np.float32)))
        self.register_buffer("valid_angle_bins", torch.from_numpy(
            angle_bins[valid].astype(np.float32)))
        self.register_buffer("range_window", torch.from_numpy(
            np.hanning(ns).astype(np.float32)))

    @property
    def ransac_rows(self) -> int:
        """Velocity rows a RANSAC fit sees: ``nv``, or ``2*nv`` with the zoom pass."""
        return 2 * self.nv if self.enable_precise else self.nv

    def draw_gumbel(self, batch: int, generator: torch.Generator,
                    device=None) -> torch.Tensor:
        """RANSAC scores ``[batch, 2, 20, ransac_rows]`` from ``generator``."""
        return ransac.gumbel((batch, 2, MAX_TRIALS, self.ransac_rows), generator,
                             device=device)

    # ------------------------------------------------------------------ stages
    def altitude_window(self, altitude: torch.Tensor):
        """Per-frame window ``start`` (int64 ``[B]``) and row mask (float32 ``[B, W]``).

        Float32 throughout, in the JAX package's order: ``start`` is the
        number of range bins below ``altitude - lower``, clipped so the
        window fits.
        """
        lo = torch.clamp_min(altitude - self.lower, 0.0)
        hi = torch.clamp_max(altitude + self.upper, self.range_max)
        start = (self.range_bins[None, :] < lo[:, None]).sum(dim=1)
        start = start.clamp(0, self.ns - self.win_rows)
        j = torch.arange(self.win_rows, dtype=torch.float32, device=altitude.device)
        bins_w = (start.to(torch.float32)[:, None] + j) * self.range_res
        rmask = ((bins_w >= lo[:, None]) & (bins_w <= hi[:, None])).to(torch.float32)
        return start, rmask

    def windowed_range_dft(self, raw: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
        """Range DFT of the window rows only: complex ``[B, W, 12, loops]``.

        The DFT columns ``start..start+W-1`` are built per frame from
        ``(s * row) mod ns`` in float32, which keeps every angle in
        ``[0, 2*pi)``; virtual channel ``v = cfg*num_rx + rx`` is a strided
        view of the raw cube.
        """
        b, ns = raw.shape[0], self.ns
        j = torch.arange(self.win_rows, dtype=torch.float32, device=raw.device)
        rows = start.to(torch.float32)[:, None] + j  # [B, W]
        s_col = torch.arange(ns, dtype=torch.float32, device=raw.device)[:, None]
        prod = s_col * rows[:, None, :]  # [B, ns, W]
        ang = (prod - ns * torch.floor(prod / ns)) * (2.0 * np.pi / ns)
        win = self.range_window[:, None]
        mat = torch.complex(torch.cos(ang) * win, -(torch.sin(ang) * win))
        r5 = raw[:, :self.num_rx].reshape(b, self.num_rx, ns, self.nv, self.cpl)
        r5 = r5.permute(0, 2, 4, 1, 3).reshape(b, ns, self.n_virt * self.nv)
        out = torch.bmm(mat.transpose(1, 2), r5)  # [B, W, 12*loops]
        return out.view(b, self.win_rows, self.n_virt, self.nv)

    def responses(self, chv: torch.Tensor, wgt: torch.Tensor,
                  row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Averaged azimuth and elevation responses ``[B, 2, nv', Av]`` from ``[B, W, 12, nv']``."""
        b, w, c, nvp = chv.shape
        u = chv.permute(0, 2, 1, 3)
        u_re = u.real.contiguous().view(b, c, w * nvp)
        u_im = u.imag.contiguous().view(b, c, w * nvp)
        resp = set_responses(u_re, u_im, wgt, self.fct, self.fst,
                             set_idx=self.set_idx, nv=nvp)  # [B, 4, Av, nv']
        if row_scale is not None:
            resp = resp * row_scale[:, None, None, :]
        # contiguous [B, 2, nv', Av]: the peak picker's masks broadcast over it
        return (0.5 * (resp[:, 0::2] + resp[:, 1::2])).transpose(-1, -2).contiguous()

    def vx_from(self, db, bins, row_valid=None):
        """``vx`` from the strongest zero-azimuth local maximum of each response.

        ``db``: ``[B, 2, n, Av]``; ``bins``: ``[B, n]``.  Each response reads
        the velocity of its peak; ``vx`` is minus their mean, or minus the one
        that has a peak, or 0.
        """
        col = db[..., self.zero_az_col]  # [B, 2, n]
        mask = local_maxima(col)
        if row_valid is not None:
            mask = mask & row_valid[:, None]
        best = torch.argmax(torch.where(mask, col, float("-inf")), dim=-1)
        found = mask.any(dim=-1)
        vel = torch.where(found, torch.gather(bins, -1, best), 0.0)
        az_v, el_v = vel.unbind(1)
        az_f, el_f = found.unbind(1)
        return torch.where(
            az_f & el_f, -0.5 * (az_v + el_v),
            torch.where(az_f, -az_v, torch.where(el_f, -el_v, 0.0)))

    def zoomed_grid(self, center: torch.Tensor):
        """Clamped two-half-band velocity grid around ``center`` (float32 ``[B]``).

        Returns ``(neg_bins, neg_ok, pos_bins, pos_ok)``: each half's ``nv``
        bins ``[B, nv]`` and whether it is present and wide enough.
        """
        vmax, nv, span = self.vmax, self.nv, self.min_span
        v0 = torch.clamp_min(center - self.precise_vel_bound, -vmax)
        v1 = torch.clamp_max(center + self.precise_vel_bound, vmax)
        spread = 2.0 * span
        need = (v1 - v0) < spread
        dist_hi = torch.abs(v1 - vmax)
        dist_lo = torch.abs(v0 + vmax)
        v1 = torch.where(need & (dist_hi > dist_lo), v0 + spread, v1)
        v0 = torch.where(need & (dist_lo > dist_hi), v1 - spread, v0)
        ar = torch.arange(nv, dtype=torch.float32, device=center.device)
        neg_stop = torch.clamp_max(v1, -1e-4)
        neg_bins = v0[:, None] + (neg_stop - v0)[:, None] * ar / nv
        pos_start = torch.clamp_min(v0, 1e-4)
        pos_bins = pos_start[:, None] + (v1 - pos_start)[:, None] * ar / nv
        neg_ok = (v0 <= 0) & (torch.abs(
            neg_bins.amax(dim=-1) - neg_bins.amin(dim=-1)) > span)
        pos_ok = (v1 > 0) & (torch.abs(
            pos_bins.amax(dim=-1) - pos_bins.amin(dim=-1)) > span)
        return neg_bins, neg_ok, pos_bins, pos_ok

    def precise_chirp_dft(self, neg_bins, pos_bins) -> torch.Tensor:
        """Per-frame zoom DFT matrices of both half bands: complex ``[B, nv, 2*nv]``.

        Keeps the reference's quirk of a zoom transform built with twice
        the sampling rate; the chirp Hann window folds into the matrix.
        """
        vmax, nv, scale = self.vmax, self.nv, self.vel_fs / self.vmax

        def half(lo, hi):
            return dft.zoom_dft_factors(lo * scale, hi * scale, n=nv, m=nv,
                                        fs=self.vel_fs * 2.0, window=np.hanning(nv))

        ncc, nss = half(neg_bins.amin(dim=-1) + 2 * vmax,
                        neg_bins.amax(dim=-1) + 2 * vmax)
        pcc, pss = half(pos_bins.amin(dim=-1), pos_bins.amax(dim=-1))
        return dft.to_matrix((torch.cat([ncc, pcc], dim=-1),
                              torch.cat([nss, pss], dim=-1)))

    def row_peaks(self, db, row_valid=None):
        """Angle of each row's highest prominent peak, and whether it has one."""
        best, found = best_prominent_peak(db, MIN_PROMINENCE_DB)
        if row_valid is not None:
            found = found & row_valid
        return self.valid_angle_bins[best], found

    def fit_vy(self, angles, vels, found, vx, scores):
        """Both ``vy`` fits in one RANSAC, on branch-selected inputs.

        ``angles``, ``found``: ``[B, 2, n]``; ``vels``: ``[B, n]``;
        ``vx``: ``[B]``.  Returns ``(vy, r2, inlier_fraction)``, each ``[B, 2]``.
        """
        use_std = vx >= 0.1
        std3 = use_std[:, None, None]
        vels = vels[:, None, :]
        vx3 = vx[:, None, None]
        y = torch.where(std3, -vels - vx3 * torch.cos(angles), angles)
        h = torch.where(std3, torch.sin(angles), vels - vx3)[..., None]
        thr = torch.where(use_std, 0.15, 0.20)[:, None]
        res = ransac.ransac_linear(h, y, found, min_samples=MIN_SAMPLES,
                                   residual_threshold=thr, max_trials=MAX_TRIALS,
                                   scores=scores)
        a = res.coef[..., 0]
        vy = torch.where(use_std[:, None], a,
                         torch.where(res.ok & (a != 0.0), -1.0 / a, 0.0))
        return vy, res.r2, res.inlier_fraction

    # ----------------------------------------------------------------- forward
    def _check_inputs(self, raw_re, raw_im, altitude):
        if raw_re.shape != raw_im.shape or raw_re.dim() != 4 \
                or tuple(raw_re.shape[-2:]) != self.frame_shape \
                or raw_re.shape[1] < self.num_rx:
            raise ValueError(
                f"expected raw planes [B, >={self.num_rx}, {self.frame_shape[0]}, "
                f"{self.frame_shape[1]}], got {tuple(raw_re.shape)} and "
                f"{tuple(raw_im.shape)}")
        if tuple(altitude.shape) != (raw_re.shape[0],):
            raise ValueError(f"expected altitudes [{raw_re.shape[0]}], got "
                             f"{tuple(altitude.shape)}")
        for t in (raw_re, raw_im, altitude):
            if t.dtype != torch.float32:
                raise TypeError(f"expected float32 inputs, got {t.dtype}")
            if t.device != self.fct.device:
                raise ValueError(f"input on {t.device}, pipeline on {self.fct.device}")

    def forward(self, raw_re: torch.Tensor, raw_im: torch.Tensor,
                altitude: torch.Tensor, *, gumbel: Optional[torch.Tensor] = None):
        self._check_inputs(raw_re, raw_im, altitude)
        b = raw_re.shape[0]
        with annotate("mmw.vel"):
            with annotate("mmw.vel.window_dft"):
                start, rmask = self.altitude_window(altitude)
                wgt = rmask / torch.clamp_min(rmask.sum(dim=1, keepdim=True), 1.0)
                rng_w = self.windowed_range_dft(torch.complex(raw_re, raw_im), start)
                chv = torch.matmul(rng_w, self.chirp_dft)  # [B, W, 12, nv]
            with annotate("mmw.vel.responses"):
                resp = self.responses(chv, wgt)
                if self.stop_after == "responses":
                    return tuple(resp.unbind(1))

            with annotate("mmw.vel.vx"):
                db = _db(resp, self.peak_threshold_db)
                bins = self.vel_bins.expand(b, self.nv)
                vx = self.vx_from(db, bins)
            if self.stop_after == "vx":
                return vx
            row_valid = None
            if self.enable_precise:
                with annotate("mmw.vel.precise"):
                    neg_bins, neg_ok, pos_bins, pos_ok = self.zoomed_grid(-vx)
                    bins = torch.cat([neg_bins, pos_bins], dim=-1)
                    row_valid = torch.cat([neg_ok[:, None].expand(b, self.nv),
                                           pos_ok[:, None].expand(b, self.nv)], dim=-1)
                    zoom = self.precise_chirp_dft(neg_bins, pos_bins)
                    chv = torch.bmm(rng_w.reshape(b, -1, self.nv), zoom)
                    chv = chv.view(b, self.win_rows, self.n_virt, 2 * self.nv)
                    with annotate("mmw.vel.responses"):
                        resp = self.responses(chv, wgt, row_valid.to(torch.float32))
                    db = _db(resp, self.peak_threshold_db)
                    vx = self.vx_from(db, bins, row_valid)

            with annotate("mmw.vel.peaks"):
                angles, found = self.row_peaks(db, None if row_valid is None
                                               else row_valid[:, None])
                if self.stop_after == "peaks":
                    return angles[:, 0], bins, found[:, 0], angles[:, 1], found[:, 1], vx
            with annotate("mmw.vel.ransac"):
                if gumbel is None:
                    gen = torch.Generator(device=raw_re.device)
                    gen.manual_seed(self.seed)
                    gumbel = self.draw_gumbel(b, gen, device=raw_re.device)
                vy, r2, inlier = self.fit_vy(angles, bins, found, vx, gumbel)
                gated = torch.where((r2 >= self.min_r2) & (inlier >= self.min_inlier), vy, 0.0)
                velocity = torch.stack([gated[:, 0], gated[:, 1], vx], dim=-1)
                return VelocityBatch(velocity, vx, r2[:, 0], r2[:, 1], inlier[:, 0],
                                     inlier[:, 1])


def build_velocity_pipeline(
    cfg: RadarConfig,
    *,
    lower_range_bound: float = 0.5,
    upper_range_bound: float = 0.5,
    num_angle_bins: int = 64,
    valid_angle_range: Sequence[float] = (np.deg2rad(-70), np.deg2rad(70)),
    peak_threshold_db: float = 30.0,
    min_r2_threshold: float = 0.6,
    min_inlier_percent: float = 0.75,
    enable_precise: bool = False,
    precise_vel_bound: float = 0.25,
    min_zoom_fft_vel_span: float = 0.1,
    seed: int = 42,
    response_backend: str = "auto",
    stop_after: Optional[str] = None,
    device,
) -> VelocityPipeline:
    """Build the velocity pipeline on ``device`` (``"cpu"`` or ``"cuda[:n]"``).

    The signature mirrors the JAX package's.  ``response_backend`` is
    ``"auto"`` only: the device decides (the plain version on the CPU, the
    CUDA kernel on a GPU); ``"xla"`` and ``"pallas"``/``"pallas2"`` name TPU
    formulations and raise.  ``stop_after`` (``"responses"``, ``"vx"``,
    ``"peaks"``) returns a stage's outputs instead of the batch.  Calls
    :func:`set_full_fp32`.
    """
    if response_backend != "auto":
        raise ValueError(f"response_backend={response_backend!r} is not ported: "
                         "the device decides ('auto')")
    if stop_after not in STOP_AFTER:
        raise ValueError(f"stop_after={stop_after!r}, expected one of {STOP_AFTER}")
    device = resolve_device(device)
    set_full_fp32()
    pipeline = VelocityPipeline(
        cfg,
        lower_range_bound=lower_range_bound,
        upper_range_bound=upper_range_bound,
        num_angle_bins=num_angle_bins,
        valid_angle_range=valid_angle_range,
        peak_threshold_db=peak_threshold_db,
        min_r2_threshold=min_r2_threshold,
        min_inlier_percent=min_inlier_percent,
        enable_precise=enable_precise,
        precise_vel_bound=precise_vel_bound,
        min_zoom_fft_vel_span=min_zoom_fft_vel_span,
        seed=seed,
        stop_after=stop_after,
    )
    return pipeline.to(device)


def load_velocity_constants(pipeline: VelocityPipeline,
                            consts: Dict[str, np.ndarray]) -> None:
    """Fill the velocity pipeline's constant buffers from the JAX package's constants.

    ``consts`` holds numpy arrays made by the JAX package's functions: the
    chirp DFT factors ``chirp_cos``/``chirp_sin`` (``mxu.dft_factors(loops,
    window=hanning, shift=True)``), the full ``[4, num_angle_bins]`` angle
    factors ``az_cos``/``az_sin`` and ``el_cos``/``el_sin``
    (``mxu.aoa_factors``; the pipeline keeps the valid columns),
    ``range_bins`` (``grids.range_bins(cfg, variant="eps")``), ``vel_bins``
    and ``angle_bins``.  Names and shapes are checked.
    """
    nv, ns, na = pipeline.nv, pipeline.ns, pipeline.num_angle_bins
    shapes = {"chirp_cos": (nv, nv), "chirp_sin": (nv, nv),
              "az_cos": (4, na), "az_sin": (4, na), "el_cos": (4, na),
              "el_sin": (4, na), "range_bins": (ns,), "vel_bins": (nv,),
              "angle_bins": (na,)}
    if set(consts) != set(shapes):
        raise ValueError(f"constant names differ: missing "
                         f"{sorted(set(shapes) - set(consts))}, unknown "
                         f"{sorted(set(consts) - set(shapes))}")
    f32 = {}
    for key, shape in shapes.items():
        value = np.array(consts[key], np.float32)
        if value.shape != shape:
            raise ValueError(f"{key}: shape {value.shape}, expected {shape}")
        f32[key] = torch.from_numpy(value)
    loaded = {
        "chirp_dft": dft.to_matrix((f32["chirp_cos"], f32["chirp_sin"])),
        "fct": _angle_tables(f32["az_cos"], f32["el_cos"], pipeline.valid_cols),
        "fst": _angle_tables(f32["az_sin"], f32["el_sin"], pipeline.valid_cols),
        "range_bins": f32["range_bins"],
        "vel_bins": f32["vel_bins"],
        "valid_angle_bins": f32["angle_bins"][pipeline.valid_cols],
    }
    with torch.no_grad():
        for buf, value in loaded.items():
            getattr(pipeline, buf).copy_(value)
