"""ndtpu_torch.graph (port of ndtpu.graph)."""
