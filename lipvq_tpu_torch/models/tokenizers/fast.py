"""FAST action tokenizer, DCT + BPE compression of action chunks
(counterpart of ``lipvq_tpu/models/tokenizers/fast.py``; Pertsch et al.
2025, arXiv:2501.09747).

1. per-dimension normalization of the action chunk [T, D] to [-1, 1]
   (1st / 99th percentile bounds over the fitting corpus)
2. DCT-II along time per dimension (``scipy.fft``, ``norm="ortho"``)
3. scale and round the coefficients to integers, shift by 128, clip to
   [0, 255]
4. flatten the [T, D] coefficients low frequencies first and run BPE
   (``prise.PriseTokenizer``, the port's native library) over the ints

All host numpy: the results are bit-equal to the JAX package's.
``features_for_policy`` turns the token ids into the ICL context stream's
text features (one text-encoder call over the union of token strings).
"""

from __future__ import annotations

import numpy as np
from scipy.fft import dct, idct

from lipvq_tpu_torch.models.tokenizers.prise import PriseTokenizer


class FastActionTokenizer:
    """DCT + BPE action-chunk tokenizer with fit / encode / decode."""

    def __init__(self, vocab_size: int = 1024, scale: float = 10.0,
                 q_low: float = 1.0, q_high: float = 99.0):
        self.vocab_size = vocab_size
        self.scale = scale
        self.q_low = q_low
        self.q_high = q_high
        self.lo = None  # [D] per-dimension quantile bounds
        self.hi = None
        self.bpe = PriseTokenizer("bpe", vocab_size)
        self._offset = 128  # int shift so negative coefficients stay >= 0

    # -- normalization -----------------------------------------------------
    def _normalize(self, chunks: np.ndarray) -> np.ndarray:
        rng = np.maximum(self.hi - self.lo, 1e-8)
        return 2.0 * (chunks - self.lo) / rng - 1.0

    def _unnormalize(self, x: np.ndarray) -> np.ndarray:
        rng = np.maximum(self.hi - self.lo, 1e-8)
        return (x + 1.0) / 2.0 * rng + self.lo

    # -- DCT quantization --------------------------------------------------
    def _to_ints(self, chunk: np.ndarray) -> list[int]:
        coeffs = dct(chunk, axis=0, norm="ortho")  # [T, D]
        q = np.round(coeffs * self.scale).astype(np.int64)
        flat = q.reshape(-1)  # row-major: low frequencies first
        ints = np.clip(flat + self._offset, 0, 255)
        return [int(v) for v in ints]

    def _from_ints(self, ints: list[int], t: int, d: int) -> np.ndarray:
        arr = np.asarray(ints, np.float32)[: t * d]
        if arr.size < t * d:
            arr = np.pad(arr, (0, t * d - arr.size))
        q = arr.reshape(t, d) - self._offset
        return idct(q / self.scale, axis=0, norm="ortho")

    # -- API ---------------------------------------------------------------
    def fit(self, chunks: np.ndarray, min_frequency: int = 2, max_token_length: int = 100):
        """chunks [N, T, D]: the quantile bounds, then the BPE over the
        chunks' ints."""
        flat = chunks.reshape(-1, chunks.shape[-1])
        self.lo = np.percentile(flat, self.q_low, axis=0).astype(np.float32)
        self.hi = np.percentile(flat, self.q_high, axis=0).astype(np.float32)
        corpus = [self._to_ints(self._normalize(c)) for c in chunks]
        self.bpe.train(corpus, min_frequency=min_frequency, max_token_length=max_token_length)

    def encode(self, chunk: np.ndarray) -> list[int]:
        """[T, D] -> BPE token ids."""
        if self.lo is None:
            raise RuntimeError("call fit() first")
        return self.bpe.encode(self._to_ints(self._normalize(chunk)))

    def decode(self, token_ids, t: int, d: int) -> np.ndarray:
        ints = self.bpe.decode(token_ids)
        return self._unnormalize(self._from_ints(ints, t, d))

    def batch_encode(self, chunks: np.ndarray) -> list[list[int]]:
        return [self.encode(c) for c in chunks]

    # -- text features of the ICL context stream ---------------------------
    def features_for_policy(self, chunks: np.ndarray, text_encoder, seq_len: int,
                            feat_dim: int = 512) -> np.ndarray:
        """chunks [N, T, D] -> [N, seq_len, feat_dim] float32: each chunk's
        token ids as strings, embedded by ``text_encoder.get_lang_emb`` in
        one call over the union of strings, cut (or zero-padded) to
        ``feat_dim``, L2-normalized, then resampled to ``seq_len`` rows
        (``np.linspace`` indices) or zero-padded (reference
        obs_nets.py:1306-1334, batched)."""
        all_ids = [self.encode(chunk) for chunk in chunks]
        vocab = sorted({str(t) for ids in all_ids for t in ids})
        table = {}
        if vocab:
            vocab_emb = np.asarray(text_encoder.get_lang_emb(vocab), np.float32)
            table = {t: vocab_emb[i] for i, t in enumerate(vocab)}

        out = np.zeros((len(chunks), seq_len, feat_dim), np.float32)
        for i, ids in enumerate(all_ids):
            emb = (np.stack([table[str(t)] for t in ids]) if len(ids)
                   else np.zeros((0, feat_dim), np.float32))
            emb = emb[..., :feat_dim]
            if emb.shape[-1] < feat_dim:
                emb = np.pad(emb, ((0, 0), (0, feat_dim - emb.shape[-1])))
            emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-8)
            n = emb.shape[0]
            if n >= seq_len:
                idx = np.linspace(0, max(n - 1, 0), seq_len).astype(int)
                out[i] = emb[idx]
            else:
                out[i, :n] = emb
        return out
