"""utils (PyTorch port; see the package docstring)."""
