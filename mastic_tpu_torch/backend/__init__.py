"""Batched protocol layer of the PyTorch port."""
