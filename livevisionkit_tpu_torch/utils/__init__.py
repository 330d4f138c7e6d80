"""utils layer of the PyTorch port (counterpart of livevisionkit_tpu/utils)."""
