"""Language embedding encoder (counterpart of ``lipvq_tpu/utils/lang_utils.py``).

The backend resolves in the JAX package's order: where CLIP weights are
cached locally (or a download is allowed with ``LIPVQ_ALLOW_DOWNLOAD=1``),
the port's CLIP text tower (``models/clip_text.py``) with those weights,
recorded as ``"clip_flax"``, the JAX name of the same function of the same
weights; otherwise, or where loading them fails, a deterministic hash
projection, bit-equal to the JAX package's. The tower runs on the encoder's
device: CUDA unless it is given one, and then it raises without a GPU, as
the port's entry points do. Embeddings are cached per string.
"""

from __future__ import annotations

import hashlib
import logging
import os

import numpy as np
import torch

LANG_EMB_DIM = 768
_CLIP_NAME = "openai/clip-vit-large-patch14"

logger = logging.getLogger(__name__)


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
    def __init__(self, model_name: str = _CLIP_NAME, device=None):
        self.model_name = model_name
        self.device = device
        self._cache: dict[str, np.ndarray] = {}
        self._backend = None
        self._tower = None
        self._tokenizer = None

    def _load(self):
        if self._backend is not None:
            return
        allow_download = os.environ.get("LIPVQ_ALLOW_DOWNLOAD", "0") == "1"
        if allow_download or _local_weights_cached(self.model_name):
            from lipvq_tpu_torch.models.clip_text import load_pretrained_clip

            # the local cache first: a download only where it is allowed
            for local_only in (True, False) if allow_download else (True,):
                try:
                    tower, tokenizer = load_pretrained_clip(
                        self.model_name, local_files_only=local_only)
                except Exception as e:  # no weights, no transformers, no network
                    logger.warning("LangEncoder: CLIP weights of %s did not load (%s: %s)",
                                   self.model_name, type(e).__name__, e)
                    continue
                self.use_tower(tower, tokenizer)
                logger.info("LangEncoder: using the CLIP text tower %s", self.model_name)
                return
        logger.warning("LangEncoder: no CLIP weights for %s; using deterministic "
                       "hash-projection embeddings. Set LIPVQ_ALLOW_DOWNLOAD=1 to fetch "
                       "them from the hub.", self.model_name)
        self._backend = "hash"

    def use_tower(self, tower: torch.nn.Module, tokenizer) -> None:
        """Embed with ``tower`` (a ``CLIPTextTower``) on the encoder's device
        from now on, ``tokenizer(strings, padding=True, return_tensors="pt")``
        giving its ``input_ids``; the backend becomes ``"clip_flax"``."""
        from lipvq_tpu_torch.algo.base import resolve_device

        self._tower = tower.to(resolve_device(self.device)).eval()
        self._tokenizer = tokenizer
        self._backend = "clip_flax"

    @property
    def backend(self) -> str:
        """The resolved embedding backend ("clip_flax" | "hash"); recorded into
        checkpoints."""
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
        missing = list(dict.fromkeys(t for t in texts if t not in self._cache))
        if missing:
            self._load()
            if self._backend == "clip_flax":
                ids = self._tokenizer(missing, padding=True, return_tensors="pt")["input_ids"]
                dev = next(self._tower.parameters()).device
                with torch.no_grad():
                    embs = self._tower(ids.to(dev)).float().cpu().numpy()
                for t, e in zip(missing, embs):
                    self._cache[t] = e
            else:
                for t in missing:
                    self._cache[t] = self._hash_embed(t)
        out = np.stack([self._cache[t] for t in texts], axis=0)
        return out[0] if single else out
