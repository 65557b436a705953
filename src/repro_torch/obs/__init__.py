"""Observability helpers; tracing and kernel watch come in later slices."""
