"""lipvq_tpu_torch — the PyTorch/CUDA port of ``lipvq_tpu``.

The JAX package stays the reference; this package mirrors its layout and
module names. It imports no JAX and nothing of ``lipvq_tpu``. Its entry
points run on the card unless the caller passes ``device="cpu"``. Its
kernels are hand-written CUDA, built with nvcc at first use: the
nearest-code lookup K1 (``ops/csrc/vq_nearest.cu``), its opt-in bf16
tensor-core variant K1f (``ops/csrc/vq_nearest_fast.cu``) and the EMA
codebook's lookup + cluster stats K2 (``ops/csrc/vq_stats.cu``).
"""
