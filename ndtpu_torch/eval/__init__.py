"""ndtpu_torch.eval (port of ndtpu.eval)."""
