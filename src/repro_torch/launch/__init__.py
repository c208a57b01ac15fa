"""Launchers of the port: ``python -m repro_torch.launch.serve`` brings up a
DisCEdge cluster and ``python -m repro_torch.launch.train`` trains (the
port's copies of ``repro.launch.serve`` / ``.train``); ``mesh``,
``shapes``, ``sharding`` and ``dryrun`` hold the multi-device launch: the
production mesh, the specs and their placement on it, and the dry-run
(``python -m repro_torch.launch.dryrun``)."""

from .mesh import HBM_BW, ICI_BW_PER_LINK, PEAK_FLOPS_BF16, data_axes, n_chips

__all__ = [
    "HBM_BW",
    "ICI_BW_PER_LINK",
    "PEAK_FLOPS_BF16",
    "data_axes",
    "n_chips",
]
