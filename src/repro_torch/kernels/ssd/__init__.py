"""Mamba-2 SSD: the chunked scan kernel and the one-token update."""
