"""Launchers of the port: ``python -m repro_torch.launch.serve`` brings up a
DisCEdge cluster (the port's copy of ``repro.launch.serve``). JAX's package
also exports its TPU mesh constants here; the port has no mesh yet, so
nothing is exported."""

__all__: list = []
