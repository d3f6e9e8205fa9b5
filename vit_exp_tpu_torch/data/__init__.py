"""Data: tokenizers, synthetic volumes and the batch loader."""
