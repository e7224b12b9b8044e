"""Analytic models of the port: parameter and FLOP counts, and the
H100 roofline."""
