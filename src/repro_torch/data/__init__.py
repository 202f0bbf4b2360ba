"""Data pipelines of the port (numpy only)."""
