"""Model zoo, rebuilt in PyTorch (so far: the decoder-only transformer)."""
