"""Serving: greedy decoding over the KV/recurrent decode state."""
