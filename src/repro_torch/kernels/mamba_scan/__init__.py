from .kernel import ssd_scan
from .ops import mamba_chunk_scan
from .ref import ssd_chunked_reference

__all__ = ["mamba_chunk_scan", "ssd_scan", "ssd_chunked_reference"]
