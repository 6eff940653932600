"""Model code: config, layers, attention, the dense decoder."""
