"""One s-step block's coefficient work on the device.

The s-step loop (``acg_torch.solvers.loops.cg_sstep_while``) builds a
(2s+1)-vector basis V and its Gram matrix G = V Vᵀ once a block; every
inner CG step then runs on the COEFFICIENTS of its vectors in V, since
<u, v> = u'ᵀ G v' and A V is the Newton change-of-basis matrix.
:func:`sstep_coeffs` is that work as one function of device tensors: the
block boundary's true residual G[s+1, s+1] and its guards, the s inner
recurrences, the history samples at each system's own cursor, the
Lanczos tridiagonal's Ritz values, Leja-ordered, as the next block's
shifts, and a status row a system that the host reads once a block
(:func:`read_status`).

:func:`sstep_coeffs` launches the hand-written kernel of
``acg_torch/csrc/sstep_coeffs.cu`` on CUDA tensors and runs
:func:`sstep_coeffs_plain` on CPU tensors.  It replaces no TPU kernel:
in the JAX package these few hundred scalar operations run inside the
s-step ``lax.while_loop`` (``acg_tpu/solvers/loops.py:419-566``), which
XLA compiles into the loop.  Every sum runs in one fixed order (j = 0,
1, ...), each product and sum rounded on its own, in both versions, so
the kernel gives the plain version's bits except where a library log
differs (the Leja order's sums of logs).

The s x s tridiagonal's eigenvalues come from Sturm-sequence bisection
with a fixed number of halvings (:func:`tridiag_eigvalsh`):
``torch.linalg.eigvalsh`` on CUDA reads its ``info`` on the host, which
a CUDA graph capture cannot hold.  There is no fallback between the
two versions: a CUDA call that cannot launch raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from acg_torch.errors import AcgError, Status
from acg_torch.utils.backend import kernel_device

# kernel launches so far (the wrapper adds one per launch, nowhere else)
launches = 0

_OK, _CONVERGED, _GRAM_BAD = 0, 1, 4     # the loop flags (solvers/loops.py)

# bisection halvings: from the Gershgorin interval down past the
# dtype's resolution for Ritz values within 2^-11 (f64) / 2^-16 (f32) of
# the interval's width
HALVINGS = {torch.float64: 64, torch.float32: 40}
THREADS = 64                   # threads of the kernel's block (a system)
SMEM_LIMIT = 48 * 1024         # shared memory a block takes without opt-in

_VEC_CODES = {torch.float32: 2, torch.float64: 3}
_LEJA_TINY = 1e-30

_lib = None


def smem_bytes(s: int, dtype) -> int:
    """Shared memory the kernel's block takes at block size ``s``: G, 8
    coefficient vectors of m = 2s+1 and 7 of s."""
    m = 2 * s + 1
    size = torch.empty((), dtype=dtype).element_size()
    return (m * m + 8 * m + 7 * s) * size


def _seq_dot(a, b):
    """Per system a_0 b_0 + a_1 b_1 + ..., left to right, each product
    and sum rounded (the kernel's order)."""
    acc = a[:, 0] * b[:, 0]
    for i in range(1, a.shape[1]):
        acc = acc + a[:, i] * b[:, i]
    return acc


def _seq_matvec(G, v):
    """Per system row i of G times v in the order of :func:`_seq_dot`."""
    acc = G[:, :, 0] * v[:, 0:1]
    for j in range(1, v.shape[1]):
        acc = acc + G[:, :, j] * v[:, j:j + 1]
    return acc


def newton_theta(shifts, s: int):
    """The Newton change-of-basis matrix's diagonal, (B, m) from the
    shifts (B, s): theta over the P block, 0 at its spill column, the
    first s - 1 shifts over the R block, 0 at its spill."""
    zcol = torch.zeros_like(shifts[:, :1])
    return torch.cat([shifts, zcol, shifts[:, : s - 1], zcol], dim=1)


def newton_apply(theta, pc, s: int):
    """A V's coefficients for the vector with coefficients ``pc`` (B, m):
    the Newton matrix (``theta`` on the diagonal, ones below it in the P
    and R blocks; ``acg_tpu.solvers.loops._newton_basis_matrix``) times
    pc in its structured form, w_i = theta_i pc_i (+ pc_{i-1} below a
    one), the kernel's order."""
    w = theta * pc
    sub = [j + 1 for j in range(s)] + [s + 2 + j for j in range(s - 1)]
    w[:, sub] = w[:, sub] + pc[:, [i - 1 for i in sub]]
    return w


def _sturm_count(d, ee, x, pivmin):
    """The number of eigenvalues at or below each of ``x`` ((B, k)) of the
    tridiagonals (d, e) with ee = e², by the LDLᵀ pivots' signs; a pivot
    within ``pivmin`` of 0 counts as -pivmin (LAPACK's dstebz rule)."""
    neg = -pivmin
    q = d[:, 0:1] - x
    q = torch.where(q.abs() < pivmin, neg, q)
    cnt = (q <= 0).to(torch.int32)
    for i in range(1, d.shape[1]):
        q = (d[:, i:i + 1] - x) - ee[:, i - 1:i] / q
        q = torch.where(q.abs() < pivmin, neg, q)
        cnt = cnt + (q <= 0).to(torch.int32)
    return cnt


def _gershgorin(d, e):
    """(lo, hi, pivmin), each (B, 1): the interval that holds every
    eigenvalue, widened by 2 s eps |T| + 2 pivmin, and the pivot floor
    tiny · max(1, max e²)."""
    dt = d.dtype
    s = d.shape[1]
    ae = e.abs()
    zero = torch.zeros_like(d[:, :1])
    left = torch.cat([zero, ae], dim=1)
    right = torch.cat([ae, zero], dim=1)
    r = left + right
    lo = (d - r).amin(dim=1, keepdim=True)
    hi = (d + r).amax(dim=1, keepdim=True)
    one = torch.ones((), dtype=dt, device=d.device)
    ee = e * e
    pivmin = torch.finfo(dt).tiny * torch.maximum((ee.amax(dim=1, keepdim=True)
                                                   if s > 1 else zero), one)
    tnorm = torch.maximum(lo.abs(), hi.abs())
    pad = tnorm * (2.0 * s * torch.finfo(dt).eps) + pivmin * 2.0
    return lo - pad, hi + pad, pivmin


def tridiag_eigvalsh(d, e, halvings: int | None = None):
    """Eigenvalues, ascending, of the symmetric tridiagonals with
    diagonals ``d`` ((B, s)) and off-diagonals ``e`` ((B, s-1)), by
    Sturm-sequence bisection: eigenvalue k is the limit of ``halvings``
    halvings (:data:`HALVINGS` of the dtype by default) of the
    Gershgorin interval, the half kept that holds more than k eigenvalues
    at or below its top.  The kernel's thread k runs the same halvings."""
    nh = HALVINGS[d.dtype] if halvings is None else int(halvings)
    B, s = d.shape
    lo, hi, pivmin = _gershgorin(d, e)
    ee = e * e
    a = lo.expand(B, s).clone()
    b = hi.expand(B, s).clone()
    kidx = torch.arange(s, device=d.device, dtype=torch.int32)
    for _ in range(nh):
        mid = (a + b) * 0.5
        up = _sturm_count(d, ee, mid, pivmin) > kidx
        b = torch.where(up, mid, b)
        a = torch.where(up, a, mid)
    return (a + b) * 0.5


def leja_order(v):
    """Leja order of each row of ``v`` ((B, s)), as
    ``acg_tpu.solvers.loops._leja_order``: the largest magnitude first,
    then greedily the point whose sum of log distances (+ 1e-30) to those
    chosen is largest, ties to the first."""
    B, s = v.shape
    tiny = torch.tensor(_LEJA_TINY, dtype=v.dtype, device=v.device)
    ninf = torch.tensor(float("-inf"), dtype=v.dtype, device=v.device)
    idx = v.abs().argmax(dim=1)
    out = [v.gather(1, idx[:, None])[:, 0]]
    picked = F.one_hot(idx, s).bool()
    logprod = torch.zeros_like(v)
    for _ in range(s - 1):
        logprod = logprod + torch.log((v - out[-1][:, None]).abs() + tiny)
        idx = torch.where(picked, ninf, logprod).argmax(dim=1)
        out.append(v.gather(1, idx[:, None])[:, 0])
        picked = picked | F.one_hot(idx, s).bool()
    return torch.stack(out, dim=1)


def _hist_put(hist, pos, mask, val):
    """hist[i, pos[i]] = val[i] where ``mask``, per system."""
    idx = pos[:, None]
    cur = hist.gather(1, idx)[:, 0]
    hist.scatter_(1, idx, torch.where(mask, val, cur)[:, None])


def sstep_coeffs_plain(G, shifts, rr, rr0, thresh2, kiter, flag, hist,
                       coef, changed, status, s: int, maxits: int,
                       any_crit: bool) -> None:
    """The plain PyTorch version of :func:`sstep_coeffs`: the same
    operations in the same order, on B systems at once."""
    B = G.shape[0]
    m = 2 * s + 1
    dt, dev = G.dtype, G.device
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    eps = torch.tensor(4.0 * m * torch.finfo(dt).eps, dtype=dt, device=dev)

    def met(r):
        hit = r < thresh2
        return hit | (r == 0) if any_crit else hit

    rr_true = G[:, s + 1, s + 1]
    gfin = torch.isfinite(G).reshape(B, -1).all(dim=1)
    difn = gfin & ~met(rr_true) & (rr_true > rr0 * 1e4)
    active0 = flag == _OK
    fl = torch.where(active0 & (~gfin | difn), _GRAM_BAD,
                     torch.where(active0 & met(rr_true), _CONVERGED, flag))
    _hist_put(hist, kiter, active0 & gfin, rr_true)
    monval = torch.where(active0, rr_true, rr)
    active = fl == _OK
    ki = kiter.clone()
    kiter0 = kiter.clone()
    theta = newton_theta(shifts, s)
    pc = torch.zeros((B, m), dtype=dt, device=dev)
    pc[:, 0] = 1
    rc = torch.zeros_like(pc)
    rc[:, s + 1] = 1
    xc = torch.zeros_like(pc)
    rr_j = rr_true.clone()
    conv_est = torch.zeros(B, dtype=torch.bool, device=dev)
    bad = torch.zeros_like(conv_est)
    allok = active.clone()
    gmax = G.abs().reshape(B, -1).amax(dim=1)
    floor_c = eps * gmax
    alphas, betas = [], []
    for _ in range(s):
        w = newton_apply(theta, pc, s)
        denom = _seq_dot(pc, _seq_matvec(G, w))
        step = active & ~bad & ~conv_est & (ki < maxits)
        zerofrozen = step & (rr_j == 0)
        attempt = step & (rr_j > 0)
        floor_p = floor_c * _seq_dot(pc, pc)
        benign = (attempt & (denom <= 0) & torch.isfinite(denom)
                  & (denom.abs() <= floor_p))
        conv_est = conv_est | benign
        indef = attempt & ~benign & ((denom <= 0) | ~torch.isfinite(denom))
        bad = bad | indef
        do = attempt & ~indef & ~benign
        alpha = torch.where(do, rr_j / torch.where(do, denom, one), zero)
        xc2 = xc + alpha[:, None] * pc
        rc2 = rc - alpha[:, None] * w
        rr_n = _seq_dot(rc2, _seq_matvec(G, rc2))
        floor_r = floor_c * _seq_dot(rc2, rc2)
        rr_n = torch.where((rr_n < 0) & (rr_n.abs() <= floor_r), zero, rr_n)
        ok2 = torch.isfinite(rr_n) & (rr_n >= 0)
        bad = bad | (do & ~ok2)
        commit = do & ok2
        xc = torch.where(commit[:, None], xc2, xc)
        rc = torch.where(commit[:, None], rc2, rc)
        counted = commit | zerofrozen
        ki = ki + counted
        _hist_put(hist, ki, counted, torch.where(commit, rr_n, rr_j))
        conv_est = conv_est | (commit & met(rr_n))
        beta = torch.where(commit, rr_n / torch.where(rr_j == 0, one, rr_j),
                           zero)
        pc = torch.where(commit[:, None], rc2 + beta[:, None] * pc, pc)
        alphas.append(alpha)
        betas.append(beta)
        allok = allok & commit
        rr_j = torch.where(commit, rr_n, rr_j)
    # a live block that committed nothing would rebuild the same basis
    # forever: the fallback takes over
    moved = ki > kiter0
    stalled = active & ~moved & (ki < maxits)
    fl = torch.where(active & (bad | stalled), _GRAM_BAD, fl)
    # on-the-fly Ritz refinement: a complete block's (alpha, beta) is a
    # Lanczos tridiagonal whose eigenvalues shift the next block
    a = torch.stack(alphas, dim=1)
    bt = torch.stack(betas, dim=1)
    a_safe = torch.where(a > 0, a, one)
    diag = one / a_safe
    diag[:, 1:] = diag[:, 1:] + bt[:, : s - 1] / a_safe[:, : s - 1]
    off = torch.sqrt(torch.clamp(bt[:, : s - 1], min=0)) / a_safe[:, : s - 1]
    valid = (allok & torch.isfinite(diag).all(dim=1)
             & torch.isfinite(off).all(dim=1))
    d = torch.where(valid[:, None], diag, one)
    e = torch.where(valid[:, None], off, zero)
    new = leja_order(tridiag_eigvalsh(d, e))
    good = valid & torch.isfinite(new).all(dim=1) & (new > 0).all(dim=1)
    shifts.copy_(torch.where(good[:, None], new, shifts))
    rr.copy_(rr_j)
    kiter.copy_(ki)
    flag.copy_(fl)
    coef[:, 0].copy_(xc)
    coef[:, 1].copy_(pc)
    changed.copy_(moved)
    live = (fl == _OK) & (ki < maxits)
    status.copy_(torch.stack([live.double(), kiter0.double(),
                              monval.double()], dim=1))


def read_status(status) -> tuple:
    """The host's one read of a block's ``status`` ((B, 3), a row a
    system), reduced over the systems: whether any can go on, the largest
    count at the block's start and the monitor's value there (the
    largest, NaN if any is NaN)."""
    st = status.cpu().numpy()
    return bool(st[:, 0].any()), int(st[:, 1].max()), float(st[:, 2].max())


def _load():
    global _lib
    if _lib is None:
        from acg_torch import _build

        lib = _build.load("sstep_coeffs")
        lib.acg_sstep_coeffs.restype = ctypes.c_int
        lib.acg_sstep_coeffs.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int64]
            + [ctypes.c_void_p] * 3
            + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
               ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p])
        _lib = lib
    return _lib


def sstep_coeffs(G, shifts, rr, rr0, thresh2, kiter, flag, hist, coef,
                 changed, status, s: int, maxits: int,
                 any_crit: bool) -> None:
    """One s-step block's coefficient work for B systems, in place.

    Reads ``G`` ((B, m, m), m = 2s+1, the block's Gram matrices),
    ``rr0`` and ``thresh2`` ((B,): |r0|² and max(atol², rtol² |r0|²)).
    Updates ``shifts`` ((B, s), the Newton shifts: the next block's when
    valid), ``rr`` ((B,), the last recurred |r|²), ``kiter`` ((B,)
    int64, each system's iteration count), ``flag`` ((B,) int32: 1 on a
    certified block boundary, 4 on a bad or stalled block) and ``hist``
    ((B, maxits+1), the |r|² samples at each system's own cursor).
    Writes ``coef`` ((B, 2, m): the x and p combinations xc, pc),
    ``changed`` ((B,) bool: a step committed) and ``status`` ((B, 3)
    float64, a row a system: whether it can go on, its count at the
    block's start, and its true |r|² there while live, else its last
    recurred one; :func:`read_status` reduces the rows).  Vectors at one float dtype (f32
    or f64), all on one device.  CPU tensors take
    :func:`sstep_coeffs_plain`; on CUDA a block size whose G does not fit
    the kernel's shared memory raises ``ERR_NOT_SUPPORTED``."""
    global launches
    if G.device.type == "cpu":
        return sstep_coeffs_plain(G, shifts, rr, rr0, thresh2, kiter, flag,
                                  hist, coef, changed, status, s, maxits,
                                  any_crit)
    if G.device.type != "cuda":
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"sstep_coeffs: no kernel for device {G.device}")
    dt = G.dtype
    m = 2 * s + 1
    B = G.shape[0]
    shapes = ((G, (B, m, m), dt), (shifts, (B, s), dt), (rr, (B,), dt),
              (rr0, (B,), dt), (thresh2, (B,), dt),
              (kiter, (B,), torch.int64), (flag, (B,), torch.int32),
              (hist, (B, maxits + 1), dt), (coef, (B, 2, m), dt),
              (changed, (B,), torch.bool), (status, (B, 3), torch.float64))
    ok = dt in _VEC_CODES and 1 <= B <= 65535 and s >= 1 and all(
        tuple(t.shape) == shp and t.dtype == tdt and t.device == G.device
        and t.is_contiguous() for t, shp, tdt in shapes)
    if not ok:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       "sstep_coeffs: operands of the wrong shape, dtype, "
                       "device or layout")
    if smem_bytes(s, dt) > SMEM_LIMIT:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"sstep_coeffs: s = {s} needs "
                       f"{smem_bytes(s, dt)} bytes of shared memory, more "
                       f"than the kernel's {SMEM_LIMIT}")
    stream = torch.cuda.current_stream(G.device).cuda_stream
    eps = 4.0 * m * torch.finfo(dt).eps
    with kernel_device(G):
        rc = _load().acg_sstep_coeffs(
            G.data_ptr(), shifts.data_ptr(), rr.data_ptr(), rr0.data_ptr(),
            thresh2.data_ptr(), kiter.data_ptr(), flag.data_ptr(),
            hist.data_ptr(), hist.shape[1], coef.data_ptr(),
            changed.data_ptr(), status.data_ptr(), _VEC_CODES[dt], B, s, maxits, int(any_crit),
            eps, HALVINGS[dt], smem_bytes(s, dt), stream)
    if rc != 0:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"sstep_coeffs: kernel launch failed (CUDA error {rc})")
    launches += 1
