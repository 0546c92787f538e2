"""Plain references: NumPy and plain PyTorch only.

Nothing here imports ``jax``, the JAX package or the port
(``aether_primitives_tpu_torch``), and nothing takes what the port has
made: each reference works its tables out again from the configuration.
"""
