"""gorse_tpu_torch.utils (port of gorse_tpu.utils)."""
