"""Share of the device's busy time in kernels that convolution ops launched
(the visual cores' trunks), by the profiler's kernel-to-op link."""


def read(s):
    t = sum(sec for op, sec in s.op_kernel_s.items() if "conv" in op)
    return 100.0 * t if t else None
