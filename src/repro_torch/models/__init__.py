"""Language models in PyTorch: plain functions over nested dicts of
tensors laid out as ``repro``'s JAX pytrees."""
