"""Placement core: geometry, folding, toruses, allocator policies."""
