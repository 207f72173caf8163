"""acg_torch: the PyTorch/CUDA port of acg_tpu's conjugate-gradient suite.

The JAX package ``acg_tpu`` stays the reference; this package imports
nothing of it (and nothing of JAX).  Entry points run on the GPU unless
the caller passes ``device="cpu"``.  The kernels are hand-written CUDA
(``csrc/``), built with ``nvcc`` on first use (``acg_torch._build``).
"""

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status

__version__ = "0.1.0"

__all__ = ["AcgError", "SolverOptions", "Status", "__version__"]
