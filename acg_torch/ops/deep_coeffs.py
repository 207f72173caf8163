"""One depth-l pipelined CG body's scalar chain on the device.

A body of the deep pipeline (``acg_torch.solvers.loops``
``cg_pipelined_deep_while``) consumes the dot block it issued l bodies
before: it finalizes column c = t+1 of the banded basis change G by
forward substitution, reads (gamma_t, delta_t) off T G = G B, and forms
the D-Lanczos update's coefficients and residual estimate.
:func:`deep_coeffs` is that chain as one function of device buffers,
updated in place: G shifted one place along its band (its oldest row
and column drop out), the flags, the estimate, the counts and the
history sample at a DEVICE index, and the coefficients the body's
vector operations read.

:func:`deep_coeffs` launches the hand-written kernel of
``acg_torch/csrc/deep_coeffs.cu`` on CUDA tensors and runs
:func:`deep_coeffs_plain` on CPU tensors: the torch chain the loop ran
before the kernel existed, operation for operation, so the kernel,
which rounds every operation on its own in the same order, gives its
bits.  It replaces no TPU kernel: in the JAX package XLA compiles this
chain into the deep pipeline's ``lax.while_loop``
(``acg_tpu/solvers/loops.py:1143-1224``).  There is no fallback between
the two: a CUDA call that cannot launch raises.

Buffers, with S the system shape (() for one system, (B,) for a batch)
and w = 2l+1: ``G`` (*S, w, w); ``D`` (*S, w), the dot block this body
consumes; ``shifts`` (*S, l), the fill chain's shifts; ``gring`` and
``dring`` (l, *S), the last l gammas and deltas, a ring whose oldest
entry is at ``hh``; ``sc`` (*S, 5): eta, d_prev, zeta_prev, the
residual estimate and the exit threshold; ``flag`` (*S) int32, ``est``
(*S) bool, ``kdev`` () int32 (the committed bodies), ``ksys`` (*S)
int32 (per system, batches only), ``kit`` () int64 (the bodies run:
the history index is kit + 1), ``hist`` (*S, maxits+1).  Outputs:
``co`` (*S, w + 5): the column rolled by ``hv`` onto the v ring
(w - 1), then lambda, zeta/dd, 1/g_cc, gamma_t, delta_{t-1}, 1/c;
``commit`` and ``act`` (*S) bool (committed; live at the body's start);
``live`` () bool (a system still live after it); ``kmon`` () int32
(kdev + 1 before the body, the monitor's count).
"""

from __future__ import annotations

import ctypes

import torch

from acg_torch.errors import AcgError, Status
from acg_torch.utils.backend import kernel_device

# kernel launches so far (the wrapper adds one per launch, nowhere else)
launches = 0

_OK, _BREAKDOWN, _FAULT = 0, 2, 3        # the loop flags (solvers/loops.py)
MAX_DEPTH = 8                            # SolverOptions.pipeline_depth's cap
NCO = 5                                  # coefficients after the column

_VEC_CODES = {torch.float32: 2, torch.float64: 3}
_lib = None


def deep_coeffs_plain(D, G, shifts, gring, dring, hh: int, sc, flag, est,
                      kdev, ksys, kit, hist, co, commit, act, live, kmon,
                      l: int, t: int, hv: int, at_check: bool, guard: bool,
                      any_crit: bool) -> None:
    """The plain PyTorch version of :func:`deep_coeffs`."""
    batched = flag.dim() == 1
    w = 2 * l + 1
    dt, dev = G.dtype, G.device
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    eta, d_prev, zeta_prev, rr_est, thresh2 = sc.unbind(-1)

    def met(g):
        m = g < thresh2
        return (m | (g == 0)) if any_crit else m

    active = (flag == _OK) & ~est
    # 1. finalize column c = t+1 of G from the l-old dot block
    Gr = torch.zeros_like(G)
    Gr[..., : w - 1, : w - 1] = G[..., 1:, 1:]
    col = []
    for a in range(w - 1):
        acc = D[..., a]
        for kk in range(a):
            acc = acc - col[kk] * Gr[..., kk, a]
        gaa = Gr[..., a, a]
        ok = gaa != 0                # rows m < 0 carry zeros: g = 0
        col.append(torch.where(ok, acc / torch.where(ok, gaa, one), zero))
    gcc2 = D[..., w - 1]
    for kk in range(w - 1):
        gcc2 = gcc2 - col[kk] * col[kk]
    good_g = gcc2 > 0                # the Cholesky diagonal stays SPD
    gcc = torch.sqrt(torch.clamp(gcc2, min=0))
    colv = torch.stack(col, dim=-1)
    Gr[..., : w - 1, w - 1] = colv
    Gr[..., w - 1, w - 1] = gcc
    G.copy_(Gr)

    # 2. the Lanczos coefficients at t from T G = G B: sigma-based while
    # the fill polynomial's degree still grows, then recurrence
    if t < l:
        base, mult = shifts[..., t], one
    else:
        base, mult = gring[hh], dring[hh]
    d_tm1 = dring[(hh + l - 1) % l]
    gii = G[..., w - 2, w - 2]
    gii_s = torch.where(gii != 0, gii, one)
    gam_t = base + (col[w - 2] * mult - d_tm1 * G[..., w - 3, w - 2]) \
        / gii_s
    del_t = gcc * mult / gii_s
    gcc_s = torch.where(gcc != 0, gcc, one)

    # 3. the D-Lanczos x-update's coefficients at t
    if t == 0:
        lam, zeta = torch.zeros_like(d_prev), eta
    else:
        lam = d_tm1 / torch.where(d_prev != 0, d_prev, one)
        zeta = -lam * zeta_prev
    dd = gam_t - d_tm1 * lam
    dd_s = torch.where(dd != 0, dd, one)
    zdd = zeta / dd_s
    rr_new = (del_t * zeta / dd_s) ** 2
    bad = (dd <= 0) | ~good_g
    cm = active & ~bad
    fl = torch.where(active & bad, _BREAKDOWN, flag)
    if guard and at_check:
        nonfin = ~(torch.isfinite(rr_new) & torch.isfinite(gcc2))
        fl = torch.where(active & nonfin, _FAULT, fl)
    es = est | (cm & met(rr_new)) if at_check else est
    k1 = kit + 1
    if batched:
        hist.index_copy_(1, k1.reshape(1),
                         torch.where(cm, rr_new, nan)[:, None])
        ksys.copy_(torch.where(cm, k1.to(torch.int32), ksys))
    else:
        cur = hist.index_select(0, k1.reshape(1))[0]
        hist.index_copy_(0, k1.reshape(1),
                         torch.where(cm, rr_new, cur).reshape(1))
    kmon.copy_(kdev + 1)
    kdev.add_(cm.any() if batched else cm)
    kit.copy_(k1)
    c_s = torch.where(del_t != 0, del_t, one)
    out = torch.stack([lam, zdd, one / gcc_s, gam_t, d_tm1, one / c_s],
                      dim=-1)
    co[..., : w - 1].copy_(torch.roll(colv, hv, dims=-1))
    co[..., w - 1:].copy_(out)
    d_prev.copy_(torch.where(cm, dd, d_prev))
    zeta_prev.copy_(torch.where(cm, zeta, zeta_prev))
    rr_est.copy_(torch.where(cm, rr_new, rr_est))
    gring[hh].copy_(gam_t)
    dring[hh].copy_(del_t)
    flag.copy_(fl)
    est.copy_(es)
    commit.copy_(cm)
    act.copy_(active)
    live.copy_(((fl == _OK) & ~es).any())


def _load():
    global _lib
    if _lib is None:
        from acg_torch import _build

        lib = _build.load("deep_coeffs")
        lib.acg_deep_coeffs.restype = ctypes.c_int
        lib.acg_deep_coeffs.argtypes = (
            [ctypes.c_void_p] * 13 + [ctypes.c_int64]
            + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
            + [ctypes.c_void_p])
        _lib = lib
    return _lib


def deep_coeffs(D, G, shifts, gring, dring, hh: int, sc, flag, est, kdev,
                ksys, kit, hist, co, commit, act, live, kmon, l: int, t: int,
                hv: int, at_check: bool, guard: bool,
                any_crit: bool) -> None:
    """One deep-pipelined body's scalar chain, in place, on the buffers
    the module docstring lists.  ``hh`` is the gamma/delta rings' oldest
    slot, ``t`` the body's update index in its dispatch (t == 0 and t <
    l take the first bodies' forms), ``hv`` the v ring's head (the column
    is rolled onto it), ``at_check`` whether the exit and the guard are
    tested in this body.  CPU tensors take :func:`deep_coeffs_plain`; a
    CUDA call with other operands raises."""
    global launches
    if G.device.type == "cpu":
        return deep_coeffs_plain(D, G, shifts, gring, dring, hh, sc, flag,
                                 est, kdev, ksys, kit, hist, co, commit, act,
                                 live, kmon, l, t, hv, at_check, guard,
                                 any_crit)
    if G.device.type != "cuda":
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"deep_coeffs: no kernel for device {G.device}")
    batched = flag.dim() == 1
    S = tuple(flag.shape)
    B = S[0] if batched else 1
    w = 2 * l + 1
    dt = G.dtype
    need = ((D, S + (w,), dt), (G, S + (w, w), dt), (shifts, S + (l,), dt),
            (gring, (l,) + S, dt), (dring, (l,) + S, dt), (sc, S + (5,), dt),
            (flag, S, torch.int32), (est, S, torch.bool),
            (kdev, (), torch.int32), (kit, (), torch.int64),
            (hist, S + (hist.shape[-1],), dt), (co, S + (w + NCO,), dt),
            (commit, S, torch.bool), (act, S, torch.bool),
            (live, (), torch.bool), (kmon, (), torch.int32))
    if batched:
        need += ((ksys, S, torch.int32),)
    ok = (dt in _VEC_CODES and 2 <= l <= MAX_DEPTH and 1 <= B <= 1024
          and all(tuple(v.shape) == shp and v.dtype == vdt
                  and v.device == G.device and v.is_contiguous()
                  for v, shp, vdt in need))
    if not ok:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       "deep_coeffs: operands of the wrong shape, dtype, "
                       "device or layout")
    stream = torch.cuda.current_stream(G.device).cuda_stream
    with kernel_device(G):
        rc = _load().acg_deep_coeffs(
            D.data_ptr(), G.data_ptr(), shifts.data_ptr(), gring.data_ptr(),
            dring.data_ptr(), sc.data_ptr(), flag.data_ptr(),
            est.data_ptr(), kdev.data_ptr(),
            ksys.data_ptr() if batched else None, kit.data_ptr(),
            hist.data_ptr(), co.data_ptr(), hist.shape[-1],
            commit.data_ptr(), act.data_ptr(), live.data_ptr(),
            kmon.data_ptr(),
            _VEC_CODES[dt], B, l, t, hh, hv, int(at_check), int(guard),
            int(any_crit), int(batched), stream)
    if rc != 0:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"deep_coeffs: kernel launch failed (CUDA error {rc})")
    launches += 1
