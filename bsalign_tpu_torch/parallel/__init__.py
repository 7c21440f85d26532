"""Data parallelism across processes (dist) and devices (mesh)."""
