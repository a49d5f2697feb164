"""Logging, device resolution and timers of the PyTorch port."""
