"""FLP layer of the PyTorch port."""
