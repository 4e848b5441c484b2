"""Collector drivers of the PyTorch port."""
