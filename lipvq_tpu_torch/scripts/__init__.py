"""Entry-point scripts of the port: ``train`` and ``eval_checkpoint``."""
