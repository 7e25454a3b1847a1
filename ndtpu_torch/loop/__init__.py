"""ndtpu_torch.loop (port of ndtpu.loop)."""
