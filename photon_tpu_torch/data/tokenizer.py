"""Tokenizers (the port of ``photon_tpu/data/tokenizer.py``): the
byte-level tokenizer that needs nothing, and Hugging Face tokenizers from
a local directory.

A directory is loaded through ``transformers.AutoTokenizer`` (imported
only here, when a directory is asked for) with the JAX package's EOS fixup:
the packing pipeline joins documents with EOS, so a tokenizer without one
gets its pad token promoted or ``<|endoftext|>`` added. A hub name is
refused: it would need a download, which this package never makes.
"""

from __future__ import annotations

import pathlib

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


def load_tokenizer(name_or_path: str):
    """``byte-fallback`` → :class:`ByteTokenizer`; an existing directory →
    its Hugging Face tokenizer with EOS patched in when missing; any other
    name raises (it would need a download)."""
    if name_or_path == BYTE_FALLBACK:
        return ByteTokenizer()
    if not pathlib.Path(name_or_path).is_dir():
        raise NotImplementedError(
            f"tokenizer {name_or_path!r} is not a local directory: a hub name needs a "
            f"download of its vocabulary, which photon_tpu_torch does not make; save the "
            f"tokenizer to a directory (save_pretrained) and pass its path, or use "
            f"'{BYTE_FALLBACK}'"
        )
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            f"loading the tokenizer directory {name_or_path!r} needs the 'transformers' "
            f"package, which is not installed (pip install transformers, or use "
            f"'{BYTE_FALLBACK}')"
        ) from e
    tok = AutoTokenizer.from_pretrained(name_or_path, local_files_only=True)
    if tok.eos_token_id is None:
        # the JAX package's fixup: promote an existing special token or add one
        if tok.pad_token_id is not None:
            tok.eos_token = tok.pad_token
        else:
            tok.add_special_tokens({"eos_token": "<|endoftext|>"})
    return tok
