"""Differentiable-rendering utilities: losses, scene-parameter gradients,
and gradient-descent scene optimisation (inverse rendering)."""

from txr_torch.diff.optimize import image_loss, optimize_scene, scene_grad, select_params

__all__ = ["scene_grad", "image_loss", "optimize_scene", "select_params"]
