"""Share of the traced window in which no kernel or copy ran on the card."""


def read(s):
    if not s.window_s or s.busy_s is None:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
