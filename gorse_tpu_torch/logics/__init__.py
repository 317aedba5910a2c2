"""gorse_tpu_torch.logics (port of gorse_tpu.logics)."""
