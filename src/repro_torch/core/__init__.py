"""LNS number system and the quantized GEMM."""
