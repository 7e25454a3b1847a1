"""ndtpu_torch.utils (port of ndtpu.utils)."""
