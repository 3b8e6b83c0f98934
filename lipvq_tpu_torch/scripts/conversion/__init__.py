"""Dataset conversion tools over exports (counterpart of
``lipvq_tpu/scripts/conversion/``, whose scripts rewrite HDF5 files)."""
