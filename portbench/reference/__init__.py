"""The benchmark's plain PyTorch reference (``model.py``). Imports nothing of
the program or of the JAX package."""
