"""Analytic models of the port (parameter counts)."""
