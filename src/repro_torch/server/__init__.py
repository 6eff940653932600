"""Per-request sampling."""
