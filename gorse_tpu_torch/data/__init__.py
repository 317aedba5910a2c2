"""gorse_tpu_torch.data (port of gorse_tpu.data)."""
