"""Rounding core: formats, grids, schemes, rounding and key derivation."""
