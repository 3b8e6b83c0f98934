"""PRISE action tokenizer: int sequences <-> BPE tokens (counterpart of
``lipvq_tpu/models/tokenizers/prise.py``).

Integer action-bin sequences are "textualized" through the GPT-2 ByteLevel
alphabet (ints -> unicode chars), BPE-trained over whitespace-split words,
encoded to token ids and decoded back to the original ints (reference
robomimic/models/prise/backbone.py:14-105).

The ``"bpe"`` algorithm is the port's own native C++ library
(``lipvq_tpu_torch/native``, built with g++ at first use), a copy of the JAX
package's: the same corpus gives the same merges, ids and serialized bytes
in both packages. ``"wordpiece"`` and ``"unigram"`` use HF ``tokenizers``,
imported only when such a tokenizer is made.
"""

from __future__ import annotations

import ctypes

import numpy as np

from lipvq_tpu_torch.native import load_bpe_lib

_SERIALIZE_CAP = 1 << 24


def byte_level_alphabet() -> list[str]:
    """The 256-char GPT-2 ByteLevel alphabet, sorted (identical to
    ``tokenizers.pre_tokenizers.ByteLevel().alphabet()``): printable bytes map
    to themselves, the rest to 0x100+offset codepoints."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAC + 1))
          + list(range(0xAE, 0xFF + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return sorted(chr(c) for c in cs)


class PriseTokenizer:
    """The reference Tokenizer's API: train / textualize / encode / decode."""

    def __init__(self, algo: str = "bpe", vocab_size: int = 2048):
        self.algo = algo
        self.vocab_size = vocab_size
        self.alphabet = byte_level_alphabet()
        self.char_index_map = {char: str(i) for i, char in enumerate(self.alphabet)}
        self._hf = None
        self._h = None
        if algo == "bpe":
            self._lib = load_bpe_lib()
            self._h = self._lib.bpe_new()
        elif algo in ("wordpiece", "unigram"):
            # the reference's HF backend (prise/backbone.py:26-42)
            import tokenizers
            from tokenizers.pre_tokenizers import WhitespaceSplit

            if algo == "wordpiece":
                from tokenizers.models import WordPiece

                self._hf = tokenizers.Tokenizer(
                    WordPiece(unk_token="[UNK]", max_input_chars_per_word=100000))
                self._hf.decoder = tokenizers.decoders.WordPiece()
            else:
                from tokenizers.models import Unigram

                self._hf = tokenizers.Tokenizer(Unigram())
            self._hf.pre_tokenizer = WhitespaceSplit()
        else:
            raise NotImplementedError(algo)

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.bpe_free(self._h)
            self._h = None

    def _native(self) -> None:
        if self._h is None:
            raise NotImplementedError(f"the {self.algo!r} tokenizer has no native BPE state")

    # -- text mapping (reference prise/backbone.py:62-82) ------------------
    def textualize(self, raw) -> str:
        if not isinstance(raw, list):
            raise TypeError(f"textualize takes a list, got {type(raw).__name__}")
        if raw and isinstance(raw[0], (int, np.integer)):
            raw = [raw]
        return " ".join("".join(self.alphabet[int(c)] for c in word) for word in raw)

    def detextualize(self, text: str) -> list[int]:
        text = " ".join(text.replace(" ", ""))
        decoded = "".join(self.char_index_map.get(ch, ch) for ch in text)
        return [int(i) for i in decoded.split(" ")]

    # -- BPE ---------------------------------------------------------------
    def train(self, corpus, min_frequency: int = 2, max_token_length: int = 100,
              verbose: bool = False):
        text = self.textualize(corpus)
        if self._hf is not None:
            from tokenizers.trainers import UnigramTrainer, WordPieceTrainer

            trainer_cls = WordPieceTrainer if self.algo == "wordpiece" else UnigramTrainer
            kwargs = dict(vocab_size=self.vocab_size, special_tokens=["[UNK]"],
                          show_progress=False)
            if self.algo == "wordpiece":
                kwargs.update(min_frequency=min_frequency)
            self._hf.train_from_iterator([text], trainer=trainer_cls(**kwargs))
            self.vocab_size = self._hf.get_vocab_size()
        else:
            self._lib.bpe_train(self._h, text.encode("utf-8"), self.vocab_size,
                                min_frequency, max_token_length)
            self.vocab_size = self._lib.bpe_vocab_size(self._h)
        if verbose:
            print(f"Learned vocab size: {self.vocab_size}")

    def encode(self, raw, verbose: bool = False) -> list[int]:
        text = self.textualize(raw)
        if self._hf is not None:
            return self._hf.encode(text).ids
        cap = max(16, 4 * len(text))
        out = (ctypes.c_int32 * cap)()
        n = self._lib.bpe_encode(self._h, text.encode("utf-8"), out, cap)
        if n > cap:
            raise RuntimeError(f"bpe_encode returned {n} ids for a buffer of {cap}")
        return list(out[:n])

    def decode(self, token_ids, verbose: bool = False) -> list[int]:
        if self._hf is not None:
            return self.detextualize(self._hf.decode([int(i) for i in token_ids]))
        ids = (ctypes.c_int32 * len(token_ids))(*[int(i) for i in token_ids])
        cap = 16 + 8 * max(1, len(token_ids)) * 8
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.bpe_decode(self._h, ids, len(token_ids), buf, cap)
        if n >= cap:
            raise RuntimeError(f"bpe_decode needs {n} bytes, the buffer holds {cap}")
        return self.detextualize(buf.value.decode("utf-8"))

    def token_str(self, token_id: int) -> str:
        self._native()
        buf = ctypes.create_string_buffer(1024)
        n = self._lib.bpe_token(self._h, int(token_id), buf, 1024)
        if not 0 <= n < 1024:
            raise ValueError(f"no token string for id {token_id} (bpe_token returned {n})")
        return buf.value.decode("utf-8")

    # -- persistence -------------------------------------------------------
    def to_bytes(self) -> bytes:
        """The vocabulary and merges as ``bpe_serialize`` writes them, up to
        the first NUL (as the JAX package's ``save`` reads ``buf.value``)."""
        self._native()
        buf = ctypes.create_string_buffer(_SERIALIZE_CAP)
        n = self._lib.bpe_serialize(self._h, buf, _SERIALIZE_CAP)
        if n >= _SERIALIZE_CAP:
            raise RuntimeError(f"the BPE serializes to {n} bytes, over {_SERIALIZE_CAP}")
        return buf.value

    def from_bytes(self, blob: bytes) -> None:
        self._native()
        self._lib.bpe_deserialize(self._h, bytes(blob))
        self.vocab_size = self._lib.bpe_vocab_size(self._h)

    def save(self, path: str):
        with open(path, "wb") as f:
            f.write(self.to_bytes())

    def load(self, path: str):
        with open(path, "rb") as f:
            self.from_bytes(f.read())
