from txr_torch.diff.optimize import image_loss, optimize_scene  # noqa: F401
