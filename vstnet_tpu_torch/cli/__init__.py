"""Command-line entry points of the PyTorch port (see the package
docstring)."""
