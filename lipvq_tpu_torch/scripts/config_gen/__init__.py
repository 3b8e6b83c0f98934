"""Config-generation CLIs of the port (twins of
``lipvq_tpu/scripts/config_gen/``)."""
