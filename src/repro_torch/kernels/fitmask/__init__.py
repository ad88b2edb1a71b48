"""Free-box search (fitmask) kernels and the engine registry."""
