"""The harness of the port's benchmark: cell lookup, traffic, the seeded
models, the traced run's instruments and the comparison that decides
``correct``. It imports the port (``plastic_unet_tpu_torch``) only inside
the functions that drive it, and never JAX."""
