"""Dry-run planning of the port (counterpart of ``repro/launch``): mesh
descriptions, sharding rules, per-(architecture x shape) step specs, the
operation count of a step on ``meta``, the H100 roofline, and the measured
step on one card."""
