"""ndtpu_torch.data (port of ndtpu.data)."""
