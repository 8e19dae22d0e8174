"""Subpackage of the PyTorch port."""
