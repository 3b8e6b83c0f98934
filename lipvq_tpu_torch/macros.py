"""Machine-level macros (counterpart of ``lipvq_tpu/macros.py``).

Base experiment paths, wandb identity, and the language-embedding obs key.
Values here are defaults; ``lipvq_tpu_torch/macros_private.py`` (generated
by ``python -m lipvq_tpu_torch.scripts.setup_macros``, git-ignored)
overrides them. ``LANG_EMB_KEY`` is defined here once:
``utils/obs_utils.py`` imports it.
"""

# base path for experiment outputs (reference EXPDATA_BASE_PATH)
EXPDATA_BASE_PATH = None

# wandb identity (reference WANDB_ENTITY / WANDB_API_KEY macros)
WANDB_ENTITY = None
WANDB_API_KEY = None

# observation key holding per-demo language embeddings (reference :19)
LANG_EMB_KEY = "lang_emb"

# fill in private overrides if present
try:
    from lipvq_tpu_torch.macros_private import *  # noqa: F401,F403
except ImportError:
    pass
