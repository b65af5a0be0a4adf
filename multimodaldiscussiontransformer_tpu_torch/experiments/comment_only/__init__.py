"""Comment-only text baseline (reference: ``Comment-Only Experiments/``), on PyTorch."""
