"""Launchers of the port: ``python -m repro_torch.launch.serve`` brings up a
DisCEdge cluster and ``python -m repro_torch.launch.train`` trains (the
port's copies of ``repro.launch.serve`` / ``.train``); ``mesh``,
``shapes``, ``sharding`` and ``dryrun`` hold the multi-device launch's
specs and cost analysis (the mesh itself, which applies them, is not
ported yet)."""

from .mesh import HBM_BW, ICI_BW_PER_LINK, PEAK_FLOPS_BF16, data_axes, n_chips

__all__ = [
    "HBM_BW",
    "ICI_BW_PER_LINK",
    "PEAK_FLOPS_BF16",
    "data_axes",
    "n_chips",
]
