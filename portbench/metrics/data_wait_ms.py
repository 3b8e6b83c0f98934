"""Host milliseconds per train step spent in ``next`` on the loader that
``run_epoch`` cycles (the benchmark's own span around the call)."""


def read(s):
    w = s.spans.get("data_wait_s")
    return 1e3 * w / s.units if w is not None and s.units else None
