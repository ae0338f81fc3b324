"""Hand-written CUDA kernels of the port (sources in ``csrc/``), built at first use."""

import torch


def wrappers():
    """Every hand-written kernel's wrapper by name; each counts its launches in ``.launches``."""
    from mmwave_radar_processing_tpu_torch.ops.kernels import (
        altitude_track, aoa_head, beamform, dbs_pick, doppler_az, os_cfar, peaks, rank_select,
        ransac_fit, steering,
    )

    return {"os_cfar_2d_detect": os_cfar.os_cfar_2d_detect,
            "os_cfar_2d_noise": os_cfar.os_cfar_2d_noise,
            "kth_smallest": rank_select.kth_smallest,
            "doppler_az_responses": doppler_az.doppler_az_responses,
            "capon_power": beamform.capon_power, "bartlett_power": beamform.bartlett_power,
            "altitude_track": altitude_track.altitude_track,
            "prominent_peak": peaks.prominent_peak,
            "steering_phases": steering.steering_phases,
            "dbs_pick": dbs_pick.dbs_pick,
            "aoa_head": aoa_head.aoa_head,
            "ransac_fit": ransac_fit.ransac_fit}


def count_launches(fn):
    """Run ``fn`` with every launch count at 0: ``(its result, {kernel: launches})``.

    Waits for the card before and after ``fn`` where this process uses
    CUDA.  The counts are per process, and a call inside another's ``fn``
    resets them.
    """
    ws = wrappers()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for w in ws.values():
        w.launches = 0
    out = fn()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out, {name: w.launches for name, w in ws.items()}
