"""Model parameters and the decoder's per-layer helpers."""
