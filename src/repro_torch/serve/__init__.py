from .engine import DecodeEngine, apply_wire_delta, apply_wire_sync, greedy_sample, temperature_sample  # noqa: F401
