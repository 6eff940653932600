"""Optimizer pieces serving needs: packing a dense tree into LNS."""
