"""data layer of the PyTorch port (counterpart of livevisionkit_tpu/data)."""
