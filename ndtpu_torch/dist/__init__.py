"""ndtpu_torch.dist (port of ndtpu.dist)."""
