"""The selective scan's share of its roofline: the counted work of the first
traced half's scan calls (``counts/<name>.py::scan``, as the driver adds it
under ``ssm_scan``: the larger of its operations over the highest dense rate
and its bytes over the HBM rate) over the device time of the kernels whose
name holds ``selective_scan``."""


def read(s):
    work = s.spans.get("ssm_scan")
    t = sum(sec for name, sec in s.kernels() if "selective_scan" in name)
    if not work or not work["elems"] or not t:
        return None
    bound = max(work["ops"] / s.peaks["flops_per_s"], work["bytes"] / s.peaks["bytes_per_s"])
    return 100.0 * bound / t
