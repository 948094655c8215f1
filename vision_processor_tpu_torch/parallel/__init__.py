"""parallel layer of the PyTorch port (mirrors vision_processor_tpu/parallel)."""
