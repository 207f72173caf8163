"""The classic CG iteration, parameterized over the operator and the dot.

The port of ``acg_tpu.solvers.loops.cg_while`` for one right-hand side.
JAX runs the whole solve as one ``lax.while_loop``; here it is a Python
loop whose state stays on the device: the scalars (``rr``, ``alpha``,
``beta``, ``p'Ap``, the flag, the iteration count) are 0-d tensors, and
breakdown and convergence are decided with tensor ops exactly as the
JAX loop body decides them.  The host reads the flag only at the
``check_every`` points (and at ``maxits``), so between checks nothing
waits for the device.

Between two checks the loop cannot stop, so an iteration that breaks
down FREEZES the state instead: the flag is sticky, alpha becomes 0 (x
and r stop moving) and the device iteration count stops advancing.  What
the host reads at the next check is then exactly what the JAX loop
returns at the breakdown.
"""

from __future__ import annotations

import torch

_OK, _CONVERGED, _BREAKDOWN, _FAULT = 0, 1, 2, 3


def cg_while(matvec, dot, b, x0, stop2, diffstop: float, maxits: int,
             track_diff: bool, check_every: int = 1, coupled_step=None,
             guard: bool = False):
    """Classic CG (ref acg/cg.c:534-637 / acg/cgcuda.c:845-1020).

    Returns ``(x, k, rr, dxx, flag, rr0, hist)``: ``x`` the iterate,
    ``k`` the iteration count (int), ``rr``/``dxx``/``rr0`` 0-d tensors
    (|r|², |dx|², |r0|²), ``flag`` an int (0 running, 1 converged, 2
    breakdown, 3 non-finite caught by the guard), ``hist`` the
    ``(maxits+1,)`` |r_k|² history, NaN past ``k``.

    ``stop2`` is the (atol², rtol²) pair of 0-d tensors; the threshold
    max(atol², rtol²·|r0|²) is formed on the device.  The loop is the
    BETA-FIRST rotation: p = r + βp opens the iteration and is followed at
    once by t = Ap and p'Ap, so ``coupled_step(r, p, beta) -> (p, t,
    p'Ap)`` can run them as one fused kernel pass.  ``coupled_step=None``
    derives the default from ``matvec``/``dot``.  ``guard`` tests |r|² and
    p'Ap for finiteness at the check points."""
    if coupled_step is None:
        def coupled_step(r, p, beta):
            p = r + beta * p
            t = matvec(p)
            return p, t, dot(p, t)

    dev, dt = b.device, b.dtype
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    r = b - matvec(x0)
    rr0 = dot(r, r)
    atol2, rtol2 = stop2
    thresh2 = torch.maximum(atol2, rtol2 * rr0)
    # an exactly-zero residual is convergence under ANY enabled criterion;
    # with every criterion off (fixed-iteration timing) the loop runs on
    any_crit = bool(atol2 > 0) or bool(rtol2 > 0) or diffstop > 0

    def met(rr):
        m = rr < thresh2
        return (m | (rr == 0)) if any_crit else m

    def code(c):
        return torch.tensor(c, dtype=torch.int32, device=dev)

    ok, conv_c, brk, fault = (code(c) for c in
                              (_OK, _CONVERGED, _BREAKDOWN, _FAULT))
    flag = torch.where(met(rr0), conv_c, ok)
    x = x0.clone()
    p = torch.zeros_like(r)
    rr, beta = rr0, zero
    dxx = torch.full((), float("inf"), dtype=dt, device=dev)
    hist = torch.full((maxits + 1,), float("nan"), dtype=dt, device=dev)
    hist[0] = rr0
    kdev = torch.zeros((), dtype=torch.int32, device=dev)
    k = 0
    running = maxits > 0 and int(flag) == _OK
    while running:
        active = flag == ok
        p, t, ptap = coupled_step(r, p, beta)
        # indefiniteness witness: for SPD A, p'Ap > 0 whenever r != 0;
        # p'Ap == 0 with rr == 0 is exact convergence (alpha = 0, no flag)
        indefinite = (ptap < 0) | ((ptap == 0) & (rr > 0))
        safe = ptap > 0
        alpha = torch.where(safe & active,
                            rr / torch.where(safe, ptap, one), zero)
        x.addcmul_(p, alpha)
        if track_diff:
            dxx = torch.where(active, alpha * alpha * dot(p, p), dxx)
        r.addcmul_(t, alpha, value=-1)
        rr_new = dot(r, r)
        hist[k + 1] = rr_new
        at_check = (k + 1) % check_every == 0
        status = torch.where(indefinite, brk, ok)
        if at_check:
            converged = met(rr_new)
            if track_diff and diffstop > 0:
                converged = converged | (dxx < diffstop)
            status = torch.where(indefinite, brk,
                                 torch.where(converged, conv_c, ok))
            if guard:
                nonfin = ~(torch.isfinite(rr_new) & torch.isfinite(ptap))
                status = torch.where(nonfin, fault, status)
        flag = torch.where(active, status, flag)
        kdev += active
        beta = rr_new / torch.where(rr == 0, one, rr)
        rr = torch.where(active, rr_new, rr)
        k += 1
        if at_check or k == maxits:
            running = k < maxits and int(flag) == _OK
    # tolerance met at exit IS convergence, whatever the flag: with
    # check_every > 1 the loop may pass the unobserved convergence point
    flag = torch.where(met(rr), conv_c, flag)
    return x, int(kdev), rr, dxx, int(flag), rr0, hist
