"""Device codec engine and host packer on PyTorch."""
