"""The RoboCasa layer of the port: the first-party MuJoCo kitchen (``sim``)
and its registries and helpers (counterpart of ``lipvq_tpu/robocasa/``)."""
