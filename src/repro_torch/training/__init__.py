"""The LNS-Madam training step, its data and its supervisor."""
