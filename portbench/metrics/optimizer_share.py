"""Share of the device's busy time in the optimizers' foreach kernels (the
global-norm clip and the AdamW updates of ``ScheduledOptimizer``), by the
profiler's kernel-to-op link."""


def read(s):
    t = sum(sec for op, sec in s.op_kernel_s.items() if "_foreach" in op)
    return 100.0 * t if t else None
