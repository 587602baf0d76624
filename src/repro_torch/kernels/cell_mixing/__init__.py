from .ops import cell_mixing, mixing_matrix, pad_mixing
from .ref import cell_mixing_ref

__all__ = ["cell_mixing", "cell_mixing_ref", "mixing_matrix", "pad_mixing"]
