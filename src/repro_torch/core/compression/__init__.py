"""Compression operators, bit accounting and error-feedback state."""
