"""CLI entry points."""
