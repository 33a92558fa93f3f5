"""Qwen2.5-VL in PyTorch (config.py is the port's copy of the JAX package's
presets)."""
