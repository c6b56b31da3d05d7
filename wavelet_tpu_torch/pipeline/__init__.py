"""End-to-end modes on PyTorch: compress / decompress."""
