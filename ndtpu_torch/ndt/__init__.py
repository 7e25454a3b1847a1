"""ndtpu_torch.ndt (port of ndtpu.ndt)."""
