"""Share of the device's busy time in host-to-device and device-to-host
copies (the corpus driver's rows up, ids down)."""


def read(s):
    t = sum(sec for _, sec in s.copies())
    return 100.0 * t / s.busy_s if t and s.busy_s else None
