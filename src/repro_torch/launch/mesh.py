"""Production mesh axes and the roofline constants of the port's card
(``repro.launch.mesh``).

Single pod: 16 x 16 = 256 devices, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 devices, axes (pod, data, model); the ``pod``
axis maps DisCEdge's geo-distributed edge sites, and context migration
moves across it (``core.mesh_context``).

The constants price one NVIDIA H100 SXM (80 GB HBM3, 700 W), the card the
port runs on; the JAX package's are a TPU's and are not used here.

``make_production_mesh`` is a function, as JAX's, so that importing this
module touches no process group.
"""

from __future__ import annotations

from typing import Tuple

# H100 SXM, per card (NVIDIA H100 Tensor Core GPU data sheet)
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12               # B/s, HBM3
# One NVLink 4 link, one direction: the H100 SXM has 18 links for 900 GB/s
# of total bidirectional bandwidth (the same data sheet), so 50 GB/s per
# link both ways and 25 GB/s each way
ICI_BW_PER_LINK = 25e9         # B/s


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production ``DeviceMesh`` on the default process group, which
    must hold ``n_chips(multi_pod)`` ranks: a real group of that many
    devices, or a fake one (``torch.testing._internal.distributed.fake_pg``)
    for the dry-run. ``device_type`` defaults to the card; without a GPU
    pass ``"cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..device import resolve_device

    device_type = resolve_device(device_type).type
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized() or dist.get_world_size() != n_chips(multi_pod):
        have = dist.get_world_size() if dist.is_initialized() else "no process group"
        raise RuntimeError(
            f"the {'x'.join(map(str, shape))} mesh needs a process group of "
            f"{n_chips(multi_pod)} ranks; the default group has {have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def data_axes(multi_pod: bool) -> Tuple[str, ...]:
    """Axes that jointly shard the batch dimension."""
    return ("pod", "data") if multi_pod else ("data",)


def n_chips(multi_pod: bool) -> int:
    return 512 if multi_pod else 256
