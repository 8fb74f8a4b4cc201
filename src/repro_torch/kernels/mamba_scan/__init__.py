from .kernel import ssd_scan, ssd_scan_bwd
from .ops import mamba_chunk_scan
from .ref import ssd_chunked_backward_reference, ssd_chunked_reference

__all__ = ["mamba_chunk_scan", "ssd_scan", "ssd_scan_bwd",
           "ssd_chunked_reference", "ssd_chunked_backward_reference"]
