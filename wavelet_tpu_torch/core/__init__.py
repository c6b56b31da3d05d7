"""Codec math on PyTorch: Haar transforms and per-box thresholds."""
