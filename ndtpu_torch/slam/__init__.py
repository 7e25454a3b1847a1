"""ndtpu_torch.slam (port of ndtpu.slam)."""
