from acg_torch.sparse.csr import (CsrMatrix, coo_to_csr, csr_from_mtx,
                                  manufactured_rhs)
from acg_torch.sparse.poisson import (poisson2d_5pt, poisson3d_7pt,
                                      poisson3d_7pt_dia,
                                      poisson3d_7pt_varcoef, poisson3d_27pt,
                                      random_spd)

__all__ = ["CsrMatrix", "coo_to_csr", "csr_from_mtx", "manufactured_rhs",
           "poisson2d_5pt", "poisson3d_7pt", "poisson3d_7pt_dia",
           "poisson3d_7pt_varcoef", "poisson3d_27pt", "random_spd"]
