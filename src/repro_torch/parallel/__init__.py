"""Sharding rules and DTensor placement (``repro.parallel``'s port)."""
