"""ndtpu_torch.eval (port of ndtpu.eval): ATE / RPE and map rendering."""

from ndtpu_torch.eval import ate, render  # noqa: F401
