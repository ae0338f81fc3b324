"""The share of the angle head's detection slots that hold a detection, in the velocity analysis.

100 x the traced run's mean detections a frame (the program's ``count``, the
``dets_per_frame`` the traffic reports) over the configuration's
``max_dets``: the slots whose points the head computes; on the card the
others cost only their flag and their zeros.
"""

LAYER = "point-cloud angles and points"
UNIT = "%"
MOVES = "frames_per_s"
KINDS = ("groundvel",)


def read(ctx):
    dets = ctx["values"].get("dets_per_frame")
    slots = ctx["cell"].config["processing"].get("max_dets")
    if dets is None or not slots:
        return None
    return 100.0 * dets / slots
