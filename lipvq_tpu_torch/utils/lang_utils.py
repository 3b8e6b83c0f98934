"""Language embedding encoder (counterpart of ``lipvq_tpu/utils/lang_utils.py``).

The JAX class resolves its backend in this order: locally cached CLIP
weights (or a download when ``LIPVQ_ALLOW_DOWNLOAD=1``) give the CLIP text
tower; otherwise a deterministic hash projection. The port has only the
hash backend, with the same bits. Where the JAX class would use CLIP, the
port raises ``NotImplementedError``: the CLIP text tower is ROADMAP §1
item 10, and embedding with another backend than the reference would
quietly change every lang_emb input.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

LANG_EMB_DIM = 768
_CLIP_NAME = "openai/clip-vit-large-patch14"


def _local_weights_cached(model_name: str) -> bool:
    """Whether a HF-hub snapshot of ``model_name`` is cached locally
    (the JAX package's probe, ``lang_utils.py:31-49``)."""
    hub_dir = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface")), "hub")
    snap = os.path.join(hub_dir, "models--" + model_name.replace("/", "--"), "snapshots")
    try:
        return any(os.scandir(snap))
    except OSError:
        return False


class LangEncoder:
    def __init__(self, model_name: str = _CLIP_NAME):
        self.model_name = model_name
        self._cache: dict[str, np.ndarray] = {}
        self._backend = None

    def _load(self):
        if self._backend is not None:
            return
        allow_download = os.environ.get("LIPVQ_ALLOW_DOWNLOAD", "0") == "1"
        if allow_download or _local_weights_cached(self.model_name):
            raise NotImplementedError(
                f"CLIP weights for {self.model_name} are cached locally (or "
                f"LIPVQ_ALLOW_DOWNLOAD=1 is set), so the JAX package would embed "
                f"language with the CLIP text tower; the port has no CLIP tower yet "
                f"(ROADMAP §1 item 10) and will not embed with another backend")
        self._backend = "hash"

    @property
    def backend(self) -> str:
        """The resolved embedding backend; recorded into checkpoints."""
        self._load()
        return self._backend

    def _hash_embed(self, text: str) -> np.ndarray:
        seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little")
        rng = np.random.default_rng(seed)
        v = rng.standard_normal(LANG_EMB_DIM).astype(np.float32)
        return v / np.linalg.norm(v)

    def get_lang_emb(self, lang):
        """str | list[str] -> [768] | [B, 768] float32."""
        single = isinstance(lang, str)
        texts = [lang] if single else list(lang)
        missing = [t for t in texts if t not in self._cache]
        if missing:
            self._load()
            for t in missing:
                self._cache[t] = self._hash_embed(t)
        out = np.stack([self._cache[t] for t in texts], axis=0)
        return out[0] if single else out
