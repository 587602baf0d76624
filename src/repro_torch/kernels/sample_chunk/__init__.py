from .ops import sample_chunk
from .ref import sample_chunk_ref

__all__ = ["sample_chunk", "sample_chunk_ref"]
