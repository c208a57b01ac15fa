from .analysis import RooflineResult, collective_bytes_by_type, model_flops

__all__ = ["RooflineResult", "collective_bytes_by_type", "model_flops"]
