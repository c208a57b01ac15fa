from .ops import ssd
from .ref import ssd_chunk_ref, ssd_sequential

__all__ = ["ssd", "ssd_chunk_ref", "ssd_sequential"]
