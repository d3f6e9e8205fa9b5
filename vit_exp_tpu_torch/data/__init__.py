"""Data: tokenizers, synthetic and planted volumes, the batch loader, the
NIfTI reader, the CT-RATE npz data sets and the packed store."""
