"""Rounding primitives of the port."""
