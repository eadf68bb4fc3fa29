"""pipeline layer of the PyTorch port (see staticfusion_tpu_torch/__init__.py)."""
