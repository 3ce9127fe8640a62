"""Tokenizers: the byte-level tokenizer that needs no download.

The port of ``photon_tpu/data/tokenizer.py``. The JAX package also loads
Hugging Face tokenizers by name (``gpt2`` and the like), which needs the
``transformers`` package and a download of the vocabulary; this package
takes neither, so :func:`load_tokenizer` refuses every name but
``byte-fallback``.
"""

from __future__ import annotations

import numpy as np

BYTE_FALLBACK = "byte-fallback"


class ByteTokenizer:
    """UTF-8 bytes plus one EOS id (vocab 257)."""

    vocab_size = 257
    eos_token_id = 256
    name_or_path = BYTE_FALLBACK

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(int(i) for i in np.asarray(ids).ravel() if i < 256).decode(
            "utf-8", errors="replace"
        )


def load_tokenizer(name_or_path: str) -> ByteTokenizer:
    """``byte-fallback`` → :class:`ByteTokenizer`; any other name raises."""
    if name_or_path == BYTE_FALLBACK:
        return ByteTokenizer()
    raise NotImplementedError(
        f"tokenizer {name_or_path!r} needs transformers and a download of its "
        f"vocabulary, which photon_tpu_torch does not take; use '{BYTE_FALLBACK}'"
    )
