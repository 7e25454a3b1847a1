"""ndtpu_torch.lie (port of ndtpu.lie)."""
