"""K1's share of its roofline: the least time of its launches (the larger of
2 B N D over the highest dense rate and its bytes over the HBM rate) over
the device time of K1's kernels in the trace."""

K1_KERNELS = ("code_norms_kernel", "nearest_tile_kernel", "reduce_splits_kernel")


def read(s):
    t = sum(sec for name, sec in s.kernels() if any(k in name for k in K1_KERNELS))
    launches = s.k1.get("launches", 0)
    if not t or not launches:
        return None
    bound = max(s.k1["ops"] / s.peaks["flops_per_s"], s.k1["bytes"] / s.peaks["bytes_per_s"])
    return 100.0 * launches * bound / t
