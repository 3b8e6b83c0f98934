"""tokenizers of the PyTorch port."""
