"""The device-resident loop's block structure, on the CPU.

The classic and pipelined loops (``acg_torch/solvers/loops.py``) run in
blocks between the host's reads, their carried state in buffers a CUDA
graph can replay (``acg_torch/solvers/graphs.py``).  On the CPU the same
blocks run as Python, through the kernels' plain versions, so the
rewrite must give the bits of the loop as it was before: that loop is
kept below (``ref_*``, the parent's ``cg_while``, ``cg_pipelined_while``
and ``_cg_pipelined_batched`` as they stood) and every block partition
(``check_every`` in {1, 3, 16}, ``segment`` ends every 1 and 7
iterations: one-iteration blocks and odd ones, the pipelined kernel's
two w buffers changing parity) is held bit for bit against it: x, the
count, the exit flag, the history, the returned norms.  Whole solves
are held against ``acg_tpu`` within the standing parity tolerances, and
the block plan, the fused update's plain version and the runner's
counts are checked directly.  The card's side (graph against open, bit
for bit) is in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.solvers.cg import cg as jcg
from acg_tpu.solvers.cg import cg_pipelined as jcg_pipelined
from acg_tpu.sparse import poisson as jpoisson
from acg_torch.config import SolverOptions
from acg_torch.ops import cg_update as cu
from acg_torch.ops.blas1 import batched_dot, ddot, pipelined_update
from acg_torch.solvers import graphs, loops
from acg_torch.solvers.cg import (_dot2, _pipe_step, build_device_operator,
                                  cg, cg_pipelined)
from acg_torch.solvers.loops import (_BREAKDOWN, _CONVERGED, _FAULT, _OK,
                                     block_plan)
from acg_torch.sparse import poisson as tpoisson


# ---------------------------------------------------------------------------
# the parent's loops, as they stood (the reference of the bits)

def ref_cg_while(matvec, dot, b, x0, stop2, diffstop, maxits: int,
             track_diff: bool, check_every: int = 1, coupled_step=None,
             guard: bool = False):
    """Classic CG (ref acg/cg.c:534-637 / acg/cgcuda.c:845-1020).

    Returns ``(x, k, rr, dxx, flag, rr0, hist)``: ``x`` the iterate,
    ``k`` the iteration count (int), ``rr``/``dxx``/``rr0`` 0-d tensors
    (|r|², |dx|², |r0|²), ``flag`` an int (0 running, 1 converged, 2
    breakdown, 3 non-finite caught by the guard), ``hist`` the
    ``(maxits+1,)`` |r_k|² history, NaN past ``k``.  Batched (``b`` of
    shape (B, n); ``dot`` then reduces per system): ``k`` and ``flag``
    are (B,) int32 tensors, the norms (B,) and ``hist`` (B, maxits+1).

    ``stop2`` is the (atol², rtol²) pair of 0-d tensors; the threshold
    max(atol², rtol²·|r0|²) is formed on the device.  ``diffstop`` is a
    float or, batched, a per-system (B,) tensor.  The loop is the
    BETA-FIRST rotation: p = r + βp opens the iteration and is followed at
    once by t = Ap and p'Ap, so ``coupled_step(r, p, beta) -> (p, t,
    p'Ap)`` can run them as one fused kernel pass.  ``coupled_step=None``
    derives the default from ``matvec``/``dot``.  ``guard`` tests |r|² and
    p'Ap for finiteness at the check points."""
    batched = b.dim() == 2
    # a (B,) per-system scalar against (B, n) vectors; identity in 1-D
    bc = (lambda v: v[:, None]) if batched else (lambda v: v)
    if coupled_step is None:
        def coupled_step(r, p, beta):
            p = r + bc(beta) * p
            t = matvec(p)
            return p, t, dot(p, t)

    dev, dt = b.device, b.dtype
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    r = b - matvec(x0)
    rr0 = dot(r, r)
    atol2, rtol2 = stop2
    thresh2 = torch.maximum(atol2, rtol2 * rr0)
    ds = torch.as_tensor(diffstop, dtype=dt, device=dev)
    # an exactly-zero residual is convergence under ANY enabled criterion
    # (per system when diffrtol gives each its own threshold); with every
    # criterion off (fixed-iteration timing) the loop runs on
    crit = (atol2 > 0) | (rtol2 > 0) | (ds > 0)
    if not bool(crit.any()):
        crit = None
    elif bool(crit.all()):
        crit = True

    def met(rr):
        m = rr < thresh2
        if crit is None:
            return m
        return m | ((rr == 0) if crit is True else crit & (rr == 0))

    def code(c):
        return torch.tensor(c, dtype=torch.int32, device=dev)

    ok, conv_c, brk, fault = (code(c) for c in
                              (_OK, _CONVERGED, _BREAKDOWN, _FAULT))
    flag = torch.where(met(rr0), conv_c, ok)
    x = x0.clone()
    p = torch.zeros_like(r)
    rr, beta = rr0, torch.zeros_like(rr0)
    dxx = torch.full_like(rr0, float("inf"))
    hist = torch.full(rr0.shape + (maxits + 1,), float("nan"), dtype=dt,
                      device=dev)
    hist[..., 0] = rr0
    kdev = torch.zeros(rr0.shape, dtype=torch.int32, device=dev)
    k = 0
    running = maxits > 0 and bool((flag == ok).any())
    while running:
        active = flag == ok
        p, t, ptap = coupled_step(r, p, beta)
        # indefiniteness witness: for SPD A, p'Ap > 0 whenever r != 0;
        # p'Ap == 0 with rr == 0 is exact convergence (alpha = 0, no flag)
        indefinite = (ptap < 0) | ((ptap == 0) & (rr > 0))
        safe = ptap > 0
        alpha = torch.where(safe & active,
                            rr / torch.where(safe, ptap, one), zero)
        x.addcmul_(p, bc(alpha))
        if track_diff:
            dxx = torch.where(active, alpha * alpha * dot(p, p), dxx)
        r.addcmul_(t, bc(alpha), value=-1)
        rr_new = dot(r, r)
        # a finished system's history stops advancing (NaN past its exit;
        # a 1-D solve's count ends its history instead)
        hist[..., k + 1] = (torch.where(active, rr_new, nan) if batched
                            else rr_new)
        at_check = (k + 1) % check_every == 0
        status = torch.where(indefinite, brk, ok)
        if at_check:
            converged = met(rr_new)
            if track_diff:
                converged = converged | ((ds > 0) & (dxx < ds))
            status = torch.where(indefinite, brk,
                                 torch.where(converged, conv_c, ok))
            if guard:
                nonfin = ~(torch.isfinite(rr_new) & torch.isfinite(ptap))
                status = torch.where(nonfin, fault, status)
        flag = torch.where(active, status, flag)
        kdev += active
        beta = rr_new / torch.where(rr == 0, one, rr)
        if batched:
            # a finished system's next direction is its frozen r: finite
            # and fixed, and never used, since its alpha is 0
            beta = torch.where(flag == ok, beta, zero)
        rr = torch.where(active, rr_new, rr)
        k += 1
        if at_check or k == maxits:
            running = k < maxits and bool((flag == ok).any())
    # tolerance met at exit IS convergence, whatever the flag: with
    # check_every > 1 the loop may pass the unobserved convergence point
    flag = torch.where(met(rr), conv_c, flag)
    if batched:
        return x, kdev, rr, dxx, flag, rr0, hist
    return x, int(kdev), rr, dxx, int(flag), rr0, hist


def ref_cg_pipelined_while(matvec, dot2, b, x0, stop2, maxits: int,
                       check_every: int = 1, replace_every: int = 0,
                       certify: bool = True, iter_step=None,
                       guard: bool = False):
    """Pipelined CG (Ghysels/Vanroose; ref acg/cgcuda.c:1676-1788) with
    ONE fused reduction point per iteration: ``dot2(a1, b1, a2, b2)``
    returns (a1·b1, a2·b2).  The port of
    ``acg_tpu.solvers.loops.cg_pipelined_while`` for one right-hand side.

    Returns ``(x, k, gamma, flag, gamma0, hist)``: ``k`` and ``flag``
    ints (flag 0 running, 1 converged, 3 non-finite caught by the guard),
    ``gamma``/``gamma0`` 0-d tensors (|r|² at exit and at x0), ``hist``
    the ``(maxits+1,)`` history of the recurred gamma, NaN past ``k``,
    holding the true residual at certification points.

    ``iter_step(z, r, p, w, s, x, alpha, beta) -> (z', p', s', x', r',
    w', gamma, delta)``, when given, runs the WHOLE body (q = A w, the
    6-vector update, both dots) as one kernel; it requires
    ``replace_every == 0``.  Otherwise the body is open-coded: ``matvec``,
    :func:`pipelined_update`, ``dot2``, and every ``replace_every``
    iterations (a host-known schedule) r = b - A x, w = A r, s = A p,
    z = A s are recomputed from their definitions.

    Restart: a non-positive recurred denominator freezes the step
    (alpha = beta = 0) and the next one re-derives the directions from
    r, w, as iteration 0 does.  Indefiniteness is not diagnosed.

    Exit CERTIFICATION (``certify``, static; callers pass it exactly when
    a criterion is enabled): an exit candidate (the recurred gamma passes
    the test, possible only at the ``check_every`` points, where the host
    reads anyway) replaces r, w, s, z from their definitions and decides
    the exit on the true gamma; a candidate that just replaced is not
    replaced again.  A loop that ends at ``maxits`` with an uncertified
    gamma below the threshold is certified after the loop.

    ``guard``: JAX tests (gamma, delta) for finiteness in the loop
    predicate, every iteration.  Here the host reads the flag only at
    the check points, so the first non-finite pair FREEZES what the loop
    returns (a sticky flag; x, gamma, the history and the count stop
    advancing), and the count is JAX's.

    A (B, n) ``b`` runs the batched loop (:func:`_cg_pipelined_batched`),
    which takes the open-coded body only: ``iter_step`` is not
    batched."""
    if iter_step is not None and replace_every > 0:
        raise ValueError("iter_step requires replace_every == 0")
    if b.dim() == 2:
        if iter_step is not None:
            raise ValueError("iter_step (the single-kernel pipelined "
                             "iteration) is not batched; callers gate it "
                             "off for multi-RHS solves")
        return ref_cg_pipelined_batched(matvec, dot2, b, x0, stop2, maxits,
                                     check_every, replace_every, certify,
                                     guard)
    dev, dt = b.device, b.dtype
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    r = b - matvec(x0)
    w = matvec(r)
    gamma0, delta0 = dot2(r, r, w, r)
    atol2, rtol2 = stop2
    thresh2 = torch.maximum(atol2, rtol2 * gamma0)
    # an exactly-zero residual is convergence when a criterion is enabled
    any_crit = bool(atol2 > 0) or bool(rtol2 > 0)

    def met(g):
        m = g < thresh2
        return (m | (g == 0)) if any_crit else m

    def replace_state(x, p):
        """r, w, s, z recomputed from their definitions."""
        r = b - matvec(x)
        w = matvec(r)
        s = matvec(p)
        return r, w, s, matvec(s)

    def finite(g, d):
        return torch.isfinite(g) & torch.isfinite(d)

    def coefficients(gamma, delta, gamma_prev, alpha_prev, fresh):
        """(alpha, beta, bad) of the next step (ref loops.py:758-767)."""
        beta = torch.where(fresh, zero, gamma / torch.where(
            gamma_prev == 0, one, gamma_prev))
        denom = torch.where(fresh, delta, delta - beta * gamma / torch.where(
            alpha_prev == 0, one, alpha_prev))
        # unusable denominator -> restart: freeze this step, re-derive
        # the directions from r, w on the next one
        bad = (denom <= 0) | (~fresh & (gamma_prev == 0))
        alpha = torch.where(bad, zero, gamma / torch.where(bad, one, denom))
        return alpha, torch.where(bad, zero, beta), bad

    def advance(k, gamma_new, delta_new, gamma, alpha, bad):
        """Record step k's gamma and form the next step's coefficients.
        Queued before the host waits on the exit candidate, so the device
        has them when the next kernel is launched."""
        hist[k] = gamma_new
        return coefficients(gamma_new, delta_new, gamma, alpha, bad)

    # separate buffers: the kernel updates z, p, s, x and r in place
    x = x0.clone()
    p, s, z = (torch.zeros_like(b) for _ in range(3))
    gamma, delta = gamma0, delta0
    fresh = torch.ones((), dtype=torch.bool, device=dev)
    coef = coefficients(gamma0, delta0, gamma0, zero, fresh)
    certified = True                       # gamma0 is a true residual
    hist = torch.full((maxits + 1,), float("nan"), dtype=dt, device=dev)
    hist[0] = gamma0
    running = ~met(gamma0)
    if guard:
        # what the loop returns, frozen at the first non-finite pair
        alive = finite(gamma0, delta0)
        x_keep = x.clone()
        kdev = torch.zeros((), dtype=torch.int32, device=dev)
        nan = torch.full((), float("nan"), dtype=dt, device=dev)
        cert_t = fresh.clone()
        cert_c = (cert_t.clone(), ~cert_t)  # certified: True, False
        running = running & alive
    k = 0
    running = maxits > 0 and bool(running)
    while running:
        live = alive if guard else None
        alpha, beta, bad = coef
        just_replaced = False
        if iter_step is not None:
            z, p, s, x, r, w, gamma_new, delta_new = iter_step(
                z, r, p, w, s, x, alpha, beta)
        else:
            z, p, s, x, r, w = pipelined_update(matvec(w), w, z, r, p, s, x,
                                                alpha, beta)
            if replace_every > 0 and (k + 1) % replace_every == 0:
                just_replaced = True
                r, w, s, z = replace_state(x, p)
            gamma_new, delta_new = dot2(r, r, w, r)
        k += 1
        at_check = k % check_every == 0
        cand_t = met(gamma_new) if certify and at_check else None
        if not guard:
            coef = advance(k, gamma_new, delta_new, gamma, alpha, bad)
        cand = False
        if cand_t is not None:
            cand = bool(cand_t & live) if guard else bool(cand_t)
            if cand and not just_replaced:
                r, w, s, z = replace_state(x, p)
                gamma_new, delta_new = dot2(r, r, w, r)
                if not guard:
                    coef = advance(k, gamma_new, delta_new, gamma, alpha,
                                   bad)
        certified = cand or just_replaced
        if guard:
            torch.where(live, x, x_keep, out=x_keep)
            cert_t = torch.where(live, cert_c[0] if certified else cert_c[1],
                                 cert_t)
            gamma_new = torch.where(live, gamma_new, gamma)
            delta_new = torch.where(live, delta_new, delta)
            coef = advance(k, torch.where(live, gamma_new, nan), delta_new,
                           gamma, alpha, bad)
            kdev += live
            alive = live & finite(gamma_new, delta_new)
        gamma, delta = gamma_new, delta_new
        if k >= maxits:
            break
        if at_check:
            # a certified candidate exits on its true gamma
            stop = cand and (just_replaced or bool(met(gamma)))
            running = not stop and (not guard or bool(alive))
    if guard:
        x, k = x_keep, int(kdev)
    if certify:
        # the maxits door, off the check schedule, can leave an
        # uncertified gamma below the threshold: certify that one too
        # (|b - A x|^2; JAX also forms w = A r, which gamma does not use)
        need = ((met(gamma) & ~cert_t) if guard
                else not certified and bool(met(gamma)))
        if bool(need):
            rt = b - matvec(x)
            gamma, _ = dot2(rt, rt, rt, rt)
        hist[k] = gamma
        flag = _CONVERGED if bool(met(gamma)) else _OK
    else:
        flag = _OK                   # no criterion: nothing can be claimed
    if guard and not bool(finite(gamma, delta)):
        flag = _FAULT
    return x, k, gamma, flag, gamma0, hist


def ref_cg_pipelined_batched(matvec, dot2, b, x0, stop2, maxits: int,
                          check_every: int, replace_every: int,
                          certify: bool, guard: bool):
    """Pipelined CG for B systems against one operator (``b`` and ``x0``
    of shape (B, n)), the port of ``acg_tpu.solvers.loops``
    ``cg_pipelined_while`` in batched mode (``:669-922``) through the
    open-coded body.  ``matvec`` and ``dot2`` act per system.

    Returns ``(x, ksys, gamma, flag, gamma0, hist)``: ``ksys`` and
    ``flag`` (B,) int32 tensors, ``gamma``/``gamma0`` (B,), ``hist`` the
    (B, maxits+1) history, NaN past each system's exit.

    Per system: its own restarts; its ``done`` mask, set by the exit test
    on its certified gamma at the ``check_every`` points (and by a
    non-finite (gamma, delta) under ``guard``); its count and history
    stop there.  Certification runs the replacement (four SpMVs) ONCE for
    the whole batch when any active system is an exit candidate, and
    blends it into the candidates only; a loop that ends at ``maxits``
    certifies each system whose gamma passes uncertified, and rewrites
    its history at its own count.  A finished system is frozen by alpha
    = beta = 0 (see the module docstring): x, r and w stay bit for bit;
    under ``guard`` x is also selected per system, since a faulted
    system's non-finite p would reach x through 0·p.  The host reads at
    the check points: whether any system is a candidate, then whether
    all are done."""
    dev, dt = b.device, b.dtype
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    r = b - matvec(x0)
    w = matvec(r)
    gamma0, delta0 = dot2(r, r, w, r)
    atol2, rtol2 = stop2
    thresh2 = torch.maximum(atol2, rtol2 * gamma0)
    any_crit = bool(atol2 > 0) or bool(rtol2 > 0)

    def met(g):
        m = g < thresh2
        return (m | (g == 0)) if any_crit else m

    def replace_state(x, p):
        """r, w, s, z recomputed from their definitions."""
        r = b - matvec(x)
        w = matvec(r)
        s = matvec(p)
        return r, w, s, matvec(s)

    x = x0.clone()
    p, s, z = (torch.zeros_like(b) for _ in range(3))
    gamma, delta = gamma0, delta0
    gamma_prev, alpha_prev = gamma0, torch.zeros_like(gamma0)
    fresh = torch.ones_like(gamma0, dtype=torch.bool)
    certified = fresh.clone()              # gamma0 is a true residual
    hist = torch.full(gamma0.shape + (maxits + 1,), float("nan"), dtype=dt,
                      device=dev)
    hist[:, 0] = gamma0
    # systems converged at x0 are done before the first iteration
    done = met(gamma0)
    ksys = torch.zeros(gamma0.shape, dtype=torch.int32, device=dev)
    k = 0
    running = maxits > 0 and not bool(done.all())
    while running:
        active = ~done
        beta = torch.where(fresh, zero, gamma / torch.where(
            gamma_prev == 0, one, gamma_prev))
        denom = torch.where(fresh, delta, delta - beta * gamma / torch.where(
            alpha_prev == 0, one, alpha_prev))
        # unusable denominator -> restart: freeze this step, re-derive the
        # directions from r, w on the next one
        bad = (denom <= 0) | (~fresh & (gamma_prev == 0))
        alpha = torch.where(bad, zero, gamma / torch.where(bad, one, denom))
        stop = bad | done
        x_old = x
        z, p, s, x, r, w = pipelined_update(
            matvec(w), w, z, r, p, s, x, torch.where(done, zero, alpha),
            torch.where(stop, zero, beta))
        just_replaced = replace_every > 0 and (k + 1) % replace_every == 0
        if just_replaced:
            r, w, s, z = replace_state(x, p)
        gamma_new, delta_new = dot2(r, r, w, r)
        k += 1
        at_check = k % check_every == 0
        cand = torch.zeros_like(active)
        if certify and at_check:
            cand = met(gamma_new) & active
            # a just-replaced gamma IS the true residual
            if not just_replaced and bool(cand.any()):
                rc, wc, sc, zc = replace_state(x, p)
                gc, dc = dot2(rc, rc, wc, rc)
                m = cand[:, None]
                r, w, s, z = (torch.where(m, new, old) for new, old in
                              ((rc, r), (wc, w), (sc, s), (zc, z)))
                gamma_new = torch.where(cand, gc, gamma_new)
                delta_new = torch.where(cand, dc, delta_new)
        if guard:
            x = torch.where(active[:, None], x, x_old)
        gamma_new = torch.where(active, gamma_new, gamma)
        delta_new = torch.where(active, delta_new, delta)
        gamma_prev = torch.where(active, gamma, gamma_prev)
        alpha_prev = torch.where(active, alpha, alpha_prev)
        fresh = torch.where(active, bad, fresh)
        certified = torch.where(active, cand | just_replaced, certified)
        hist[:, k] = torch.where(active, gamma_new, nan)
        if at_check:
            # the exit decision per system, on the (certified) gamma
            done = done | (active & met(gamma_new))
        if guard:
            done = done | (active & ~(torch.isfinite(gamma_new)
                                      & torch.isfinite(delta_new)))
        ksys = torch.where(active, k, ksys)
        gamma, delta = gamma_new, delta_new
        if k >= maxits:
            break
        if at_check:
            running = not bool(done.all())
    if certify:
        # the maxits door, off the check schedule, can leave an
        # uncertified gamma below the threshold: certify those too
        need = met(gamma) & ~certified
        if bool(need.any()):
            rt = b - matvec(x)
            g, _ = dot2(rt, rt, rt, rt)
            gamma = torch.where(need, g, gamma)
        # each system's last sample is its certified exit value
        hist[torch.arange(gamma.shape[0], device=dev), ksys.long()] = gamma
        flag = torch.where(met(gamma), _CONVERGED, _OK).to(torch.int32)
    else:
        flag = torch.full(gamma.shape, _OK, dtype=torch.int32, device=dev)
    if guard:
        flag = torch.where(torch.isfinite(gamma) & torch.isfinite(delta),
                           flag, _FAULT).to(torch.int32)
    return x, ksys, gamma, flag, gamma0, hist


def ref_pipe_step(op):
    """The parent's ``iter_step``: two w buffers alternated through a
    Python ``spare``."""
    spare = [None]

    def step(z, r, p, w, s, x, alpha, beta):
        out = op.pipelined_iter(w, z, r, p, s, x, alpha, beta,
                                w_out=spare[0])
        spare[0] = w
        return out

    return step


# ---------------------------------------------------------------------------
# the cases


def _system(batch: int, fmt: str, edge: int = 9, seed: int = 3):
    A = tpoisson.poisson3d_7pt(edge)
    op = build_device_operator(A, dtype=np.float64, fmt=fmt, device="cpu")
    rng = np.random.default_rng(seed)
    n, npad = A.nrows, op.nrows_padded
    xs = rng.standard_normal((max(batch, 1), n))
    b = np.stack([A.matvec(v) for v in xs])
    bt = torch.zeros((max(batch, 1), npad), dtype=torch.float64)
    bt[:, :n] = torch.from_numpy(b)
    return A, op, (bt if batch else bt[0]).contiguous()


def _stop(rtol):
    return (torch.zeros((), dtype=torch.float64),
            torch.tensor(rtol ** 2, dtype=torch.float64))


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b) or (
            a.is_floating_point() and torch.equal(torch.isnan(a),
                                                  torch.isnan(b))
            and torch.equal(a[~torch.isnan(a)], b[~torch.isnan(b)]))
    return a == b


def _classic(op, b, check_every, guard, segment=None, track_diff=False):
    batched = b.dim() == 2
    x0 = torch.zeros_like(b)

    def coupled(r, p, beta):
        torch.addcmul(r, p, beta[:, None] if batched else beta, out=p)
        t, ptap = op.matvec_dot(p)
        return p, t, ptap

    diffstop = 1e-18 if track_diff else 0.0
    args = (op.matvec, ddot, b, x0, _stop(1e-10), diffstop, 300, track_diff)
    kw = dict(check_every=check_every, coupled_step=coupled, guard=guard)
    if segment is None:
        return ref_cg_while(*args, **kw)
    return loops.cg_while(*args, **kw, segment=segment, update=lambda *a:
                          cu.cg_update(*a, track_diff))


def _pipelined(op, b, check_every, guard, replace_every, kernel,
               segment=None):
    x0 = torch.zeros_like(b)
    args = (op.matvec, _dot2, b, x0, _stop(1e-10), 300)
    kw = dict(check_every=check_every, replace_every=replace_every,
              guard=guard)
    if segment is None:
        return ref_cg_pipelined_while(
            *args, **kw, iter_step=ref_pipe_step(op) if kernel else None)
    return loops.cg_pipelined_while(
        *args, **kw, iter_step=_pipe_step(op) if kernel else None,
        segment=segment)


_KINDS = {
    # kind: (batch, fmt, runner)
    "classic": (0, "auto", lambda op, b, c, g, s: _classic(op, b, c, g, s)),
    "classic-diff": (0, "dia", lambda op, b, c, g, s: _classic(
        op, b, c, g, s, track_diff=True)),
    "classic-batched": (3, "auto",
                        lambda op, b, c, g, s: _classic(op, b, c, g, s)),
    "pipelined-kernel": (0, "auto", lambda op, b, c, g, s: _pipelined(
        op, b, c, g, 0, True, s)),
    "pipelined-dia-kernel": (0, "dia", lambda op, b, c, g, s: _pipelined(
        op, b, c, g, 0, True, s)),
    "pipelined-open-coded": (0, "auto", lambda op, b, c, g, s: _pipelined(
        op, b, c, g, 0, False, s)),
    "pipelined-replace": (0, "auto", lambda op, b, c, g, s: _pipelined(
        op, b, c, g, 5, False, s)),
    "pipelined-batched": (3, "auto", lambda op, b, c, g, s: _pipelined(
        op, b, c, g, 0, False, s)),
    "pipelined-batched-replace": (3, "dia", lambda op, b, c, g, s:
                                  _pipelined(op, b, c, g, 4, False, s)),
}


@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("check_every", [1, 3, 16])
@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_blocks_give_the_parent_loops_bits(kind, check_every, guard):
    """Whatever the block partition (the plain one, one-iteration blocks,
    segments of 7 across the check points), the loop returns the bits of
    the parent's loop."""
    batch, fmt, run = _KINDS[kind]
    _, op, b = _system(batch, fmt)
    ref = run(op, b, check_every, guard, None)
    for segment in (0, 1, 7):
        got = run(op, b, check_every, guard, segment)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert _equal(g, r), (segment, g, r)


def test_odd_blocks_alternate_the_w_buffers():
    """The pipelined kernel writes w' beside w: with blocks of 3 the two
    buffers change roles every block, and the iterate still has the
    parent's bits; the loop never allocates a third buffer."""
    _, op, b = _system(0, "auto")
    seen = set()
    step = _pipe_step(op)

    def watch(z, r, p, w, s, x, alpha, beta, w_out):
        seen.update((w.data_ptr(), w_out.data_ptr()))
        assert w.data_ptr() != w_out.data_ptr()
        return step(z, r, p, w, s, x, alpha, beta, w_out)

    got = loops.cg_pipelined_while(
        op.matvec, _dot2, b, torch.zeros_like(b), _stop(1e-10), 300,
        check_every=3, iter_step=watch)
    ref = ref_cg_pipelined_while(
        op.matvec, _dot2, b, torch.zeros_like(b), _stop(1e-10), 300,
        check_every=3, iter_step=ref_pipe_step(op))
    assert len(seen) == 2 and got[1] > 3
    for g, r in zip(got, ref):
        assert _equal(g, r)


@pytest.mark.parametrize("edges", [(0, 1, 1, False, False),
                                   (0, 3, 1, True, False),
                                   (5, 3, 0, False, False),
                                   (9, 4, 10, False, False),
                                   (10, 4, 10, True, True),
                                   (10, 16, 3, False, True)])
def test_block_plan(edges):
    """A block runs to the next check point, segment end, replacement
    point or maxits, whichever comes first."""
    k, check_every, segment, at_check, at_rep = edges
    n, check, rep = block_plan(k, 40, check_every, segment, 5)
    end = k + n
    cands = [40, (k // check_every + 1) * check_every,
             (k // 5 + 1) * 5] + ([(k // segment + 1) * segment]
                                  if segment else [])
    assert end == min(cands) and n >= 1
    assert check == (end % check_every == 0)
    assert rep == (end % 5 == 0)


@pytest.mark.parametrize("want_pp", [False, True])
@pytest.mark.parametrize("batch", [0, 3])
def test_cg_update_plain_is_the_parent_arithmetic(batch, want_pp):
    """On the CPU the fused update is the classic loop's two addcmul_ and
    its dots, in the parent's order (|p|² before r moves)."""
    rng = np.random.default_rng(batch)
    shape = (batch, 50) if batch else (50,)
    x, r, p, t = (torch.from_numpy(rng.standard_normal(shape))
                  for _ in range(4))
    a = torch.from_numpy(rng.random(batch) if batch else np.array(0.3))
    ab = a[:, None] if batch else a
    xr, rr_ = x.clone(), r.clone()
    xr.addcmul_(p, ab)
    pp_ref = batched_dot(p, p)
    rr_.addcmul_(t, ab, value=-1)
    before = cu.launches
    got_rr, got_pp = cu.cg_update(x, r, p, t, a, want_pp)
    assert cu.launches == before            # no kernel on the CPU
    assert torch.equal(x, xr) and torch.equal(r, rr_)
    assert torch.equal(got_rr, batched_dot(rr_, rr_))
    assert (got_pp is None) != want_pp
    if want_pp:
        assert torch.equal(got_pp, pp_ref)


def test_block_runner_open_counts_and_refuses_graphs_off_cuda():
    from acg_torch.errors import AcgError
    from acg_torch.solvers.base import SolveStats

    st = SolveStats()
    runner = graphs.BlockRunner("cpu", graph=False, stats=st)
    calls = []
    for key in ("a", "a", "b"):
        runner.run(key, lambda: calls.append(1))
    assert len(calls) == 3 and runner.nopen == 3 and st.nloopopen == 3
    assert st.ncaptures == st.nreplays == 0 and st.tcapture == 0.0
    with pytest.raises(AcgError):
        graphs.BlockRunner("cpu", graph=True)
    names = {(m, a) for m, a in graphs.COUNTERS}
    assert ("acg_torch.ops.cg_update", "launches") in names
    assert len(graphs.counts()) == len(graphs.COUNTERS)


def test_loop_argument_is_resolved_per_device():
    """The graph loop is the default on one CUDA device only; asking for
    it on the CPU raises, and the result says which loop ran."""
    from acg_torch.errors import AcgError

    A, op, b = _system(0, "auto")
    res = cg(op, b.numpy()[: A.nrows], device="cpu",
             options=SolverOptions(maxits=200, residual_rtol=1e-8))
    assert res.loop == "open" and "open loop" not in res.kernel_note
    assert res.stats.nloopopen >= 1 and res.stats.ncaptures == 0
    with pytest.raises(AcgError):
        cg(op, b.numpy()[: A.nrows], device="cpu", loop="graph")
    with pytest.raises(AcgError):
        cg_pipelined(op, b.numpy()[: A.nrows], device="cpu", loop="sideways")


# ---------------------------------------------------------------------------
# whole solves against the JAX package


@pytest.mark.parametrize("check_every", [1, 3, 16])
@pytest.mark.parametrize("solver", ["cg", "cg_pipelined", "cg-batched",
                                    "cg_pipelined-replace"])
def test_block_loops_match_acg_tpu(solver, check_every):
    """f64: equal counts and x to 1e-10 relative; f32 (classic): counts
    within 1 and x to the solve's tolerance."""
    Aj, At = jpoisson.poisson3d_7pt(10), tpoisson.poisson3d_7pt(10)
    rng = np.random.default_rng(11)
    b = At.matvec(rng.standard_normal(At.nrows))
    if solver == "cg-batched":
        b = np.stack([b, At.matvec(rng.standard_normal(At.nrows))])
    o = dict(maxits=500, residual_rtol=1e-10, check_every=check_every,
             replace_every=7 if solver.endswith("replace") else 0)
    pipe = solver.startswith("cg_pipelined")
    tf, jf = (cg_pipelined, jcg_pipelined) if pipe else (cg, jcg)
    rt = tf(At, b, options=SolverOptions(**o), device="cpu")
    rj = jf(Aj, b, options=JOptions(**o))
    assert rt.niterations == rj.niterations
    scale = np.abs(np.asarray(rj.x)).max()
    assert np.abs(rt.x - np.asarray(rj.x)).max() <= 1e-10 * scale
    if solver == "cg":
        r32 = cg(At, b.astype(np.float32), dtype=np.float32, device="cpu",
                 options=SolverOptions(maxits=500, residual_rtol=1e-5,
                                       check_every=check_every))
        j32 = jcg(Aj, b.astype(np.float32), dtype=np.float32,
                  options=JOptions(maxits=500, residual_rtol=1e-5,
                                   check_every=check_every))
        assert abs(r32.niterations - j32.niterations) <= 1
        assert np.linalg.norm(b - At.matvec(r32.x.astype(np.float64))) \
            <= 10 * 1e-5 * np.linalg.norm(b)
