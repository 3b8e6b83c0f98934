"""lipvq_tpu_torch — the PyTorch/CUDA port of ``lipvq_tpu``.

The JAX package stays the reference; this package mirrors its layout and
module names. It imports no JAX and nothing of ``lipvq_tpu``. Its entry
points run on the card unless the caller passes ``device="cpu"``; the one
kernel on the served path, the nearest-code lookup K1, is hand-written CUDA
(``ops/csrc/vq_nearest.cu``) and built with nvcc at first use.
"""
