"""Observability of the port: in-graph numerics stats, the serving
tree's code-rail occupancy and the Prometheus exposition (the observer,
spans and timeline come later)."""
