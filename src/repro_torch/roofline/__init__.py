from .analysis import RooflineResult, model_flops

__all__ = ["RooflineResult", "model_flops"]
