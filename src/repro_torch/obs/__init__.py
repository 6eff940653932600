"""In-graph numerics stats of the port (the observer comes later)."""
