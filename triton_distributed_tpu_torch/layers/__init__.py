"""Layers of the PyTorch port (attention and MLP at tp=1)."""
