"""Decoder model: layers, attention, dense blocks, model factory."""
