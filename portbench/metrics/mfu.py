"""The whole step's share of the card's peak: the analytic FLOPs of the
traced window's work (``counts/flops.py``) over the window's time over the
highest dense rate of ``counts/peaks.json``."""


def read(s):
    if not s.flops or not s.window_s:
        return None
    return 100.0 * s.flops / s.window_s / s.peaks["flops_per_s"]
