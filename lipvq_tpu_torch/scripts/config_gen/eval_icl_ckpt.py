"""ICL checkpoint evaluation generator (reference config_gen/eval_icl_ckpt.py
— same flow as eval_ckpt; kept as its own entry point for CLI parity).

The port's twin of ``lipvq_tpu/scripts/config_gen/eval_icl_ckpt.py``.
"""

from lipvq_tpu_torch.scripts.config_gen.eval_ckpt import main

if __name__ == "__main__":
    main()
