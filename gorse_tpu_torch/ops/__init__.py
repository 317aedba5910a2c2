"""gorse_tpu_torch.ops (port of gorse_tpu.ops)."""
