"""gorse_tpu_torch.storage (port of gorse_tpu.storage)."""
