"""Share of the device's busy time in the selective scan's kernels (every
kernel whose name holds ``selective_scan``: forward, backward and the
backward's reductions)."""


def read(s):
    t = sum(sec for name, sec in s.kernels() if "selective_scan" in name)
    return 100.0 * t / s.busy_s if t and s.busy_s else None
