"""Host-side data bridge of the PyTorch port."""
