"""runtime layer of the PyTorch port (counterpart of livevisionkit_tpu/runtime)."""
