"""The CG iterations, parameterized over the operator and the dots.

The port of ``acg_tpu.solvers.loops`` ``cg_while`` (classic) and
``cg_pipelined_while`` (pipelined).  JAX runs the whole solve as one
``lax.while_loop``; here the loop's state stays on the device: the
scalars (``rr``, ``alpha``, ``beta``, ``p'Ap``, the flag, the iteration
count) are 0-d tensors, and breakdown and convergence are decided with
tensor ops exactly as the JAX loop body decides them.  The history is
written through a device index.  The host reads the device only at the
``check_every`` points (and at ``maxits`` and the ``segment`` ends), so
between two reads nothing waits for the device.

The iterations between two reads are a BLOCK, a fixed sequence of
kernel launches whose carried tensors live in buffers that the block
reads at its start and writes at its end.  ``graph=True`` (a CUDA
device) captures each distinct block once as a CUDA graph and replays it
(``acg_torch/solvers/graphs.py``); ``graph=False`` runs the same block
as Python.  What the host decides between blocks (the exit test,
pipelined certification, the restart) runs eagerly in both, so the two
give the same bits.  ``segment`` > 0 ends a block every ``segment``
iterations as well (``SolverOptions.segment_iters``, the JAX package's
re-dispatch), which changes no result.  ``monitor_every`` > 0 keeps the
scalar each iteration reports on the device and emits the lines at the
reads (``acg_torch/obs/monitor.py``).

Between two checks the loop cannot stop, so an iteration that breaks
down FREEZES the state instead: the flag is sticky, alpha becomes 0 (x
and r stop moving) and the device iteration count stops advancing.  What
the host reads at the next check is then exactly what the JAX loop
returns at the breakdown.

BATCHED mode (``b`` of shape (B, n), B systems against one operator):
the scalars become (B,) tensors, each system keeps its own flag and
iteration count and a (B, maxits+1) history, NaN past its own exit, and
the loop runs until every system has finished.  A finished system
FREEZES as in the JAX batched loops, at no extra pass over the vectors:
its alpha (and, pipelined, beta) is 0, so x + 0·p and r - 0·t leave x
and r bit for bit, its scalars and history are selected per system, and
its other recurred vectors (JAX keeps them with a (B, n) ``where`` each
iteration) only take finite values no result reads.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from acg_torch.obs.monitor import LoopMonitor, emit_residual_line
from acg_torch.ops.blas1 import pipelined_update_
from acg_torch.solvers.graphs import BlockRunner

_OK, _CONVERGED, _BREAKDOWN, _FAULT = 0, 1, 2, 3
# s-step only: the Gram factorization went indefinite or non-finite (an
# ill-conditioned basis, or an operator that is not SPD: the coefficient
# recurrence cannot tell them apart); the wrapper falls back to classic
# CG from the current iterate and says so in SolveResult.kernel_note
_GRAM_BAD = 4


def block_plan(k: int, maxits: int, check_every: int, segment: int = 0,
               replace_every: int = 0) -> tuple:
    """The block that starts after ``k`` iterations: ``(length, ends at a
    check point, ends at a scheduled replacement)``.  It runs to the next
    ``check_every`` point, ``segment`` end, ``replace_every`` point or
    ``maxits``, whichever comes first."""
    end = min(maxits, (k // check_every + 1) * check_every)
    if segment > 0:
        end = min(end, (k // segment + 1) * segment)
    if replace_every > 0:
        end = min(end, (k // replace_every + 1) * replace_every)
    return (end - k, end % check_every == 0,
            replace_every > 0 and end % replace_every == 0)


def _keep(dst, src) -> None:
    """``src``'s values into ``dst``'s buffer where they are different
    tensors (shard by shard for per-shard vectors)."""
    if isinstance(dst, torch.Tensor):
        if dst is not src:
            dst.copy_(src)
        return
    for a, c in zip(dst, src):
        if a is not c:
            a.copy_(c)


class _Buffers:
    """The buffers a block reads its carried tensors from: those ``names``
    of ``carry`` hold when the loop starts.  With ``graph`` (a capture
    reads and writes fixed addresses), :meth:`commit` copies every value
    a name was rebound to back into its buffer, in ``names`` order (a
    name that may hold another's buffer comes before it); it runs at the
    end of every block and before every block, after the host's eager
    work between two.  Without ``graph`` nothing is copied."""

    def __init__(self, carry, names, graph: bool):
        self.carry, self.names, self.graph = carry, names, graph
        self.bufs = {n: getattr(carry, n) for n in names}

    def commit(self) -> None:
        if not self.graph:
            return
        for n in self.names:
            v, buf = getattr(self.carry, n), self.bufs[n]
            if v is not buf:
                _keep(buf, v)
                setattr(self.carry, n, buf)

    def block(self, body):
        """``body`` as a block: run, then commit."""
        def run():
            body()
            self.commit()
        return run


def _reader(mon):
    """The host's read at a read point: ``read(pred, hi)`` is
    ``bool(pred)``; with a monitor, its values through iteration ``hi``
    come in the same copy and are emitted."""
    if mon is None:
        return lambda pred, hi: bool(pred)
    return mon.read


def _monitor(every: int, maxits: int, dt, dev):
    return LoopMonitor(every, maxits, dt, dev) if every > 0 else None


def cg_while(matvec, dot, b, x0, stop2, diffstop, maxits: int,
             track_diff: bool, check_every: int = 1, coupled_step=None,
             guard: bool = False, update=None, segment: int = 0,
             monitor_every: int = 0, graph: bool = False, stats=None):
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
    derives the default from ``matvec``/``dot``.  ``update(x, r, p, t,
    alpha) -> (rr, pp)`` moves x and r in place and returns the new |r|²
    (and |p|² when ``track_diff``, else None): one kernel pass
    (``acg_torch/ops/cg_update.py``); None runs ``addcmul_`` twice and
    ``dot``.  ``guard`` tests |r|² and p'Ap for finiteness at the check
    points.  ``segment``, ``monitor_every``, ``graph``: see the module
    docstring; ``stats`` (a ``SolveStats``) gets the block counts and
    the capture seconds."""
    batched = b.dim() == 2
    # a (B,) per-system scalar against (B, n) vectors; identity in 1-D
    bc = (lambda v: v[:, None]) if batched else (lambda v: v)
    if coupled_step is None:
        def coupled_step(r, p, beta):
            p = r + bc(beta) * p
            t = matvec(p)
            return p, t, dot(p, t)
    if update is None:
        def update(x, r, p, t, alpha):
            a = bc(alpha)
            x.addcmul_(p, a)
            pp = dot(p, p) if track_diff else None
            r.addcmul_(t, a, value=-1)
            return dot(r, r), pp

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
    x = x0.clone()
    hist = torch.full(rr0.shape + (maxits + 1,), float("nan"), dtype=dt,
                      device=dev)
    hist[..., 0] = rr0
    hdim = hist.dim() - 1
    # the carried state: x and r move in place; the rest is rebound by a
    # block and (graph) copied back into these buffers at its end
    c = types.SimpleNamespace(
        p=torch.zeros_like(r), rr=rr0.clone(), beta=torch.zeros_like(rr0),
        dxx=torch.full_like(rr0, float("inf")),
        flag=torch.where(met(rr0), conv_c, ok),
        kdev=torch.zeros(rr0.shape, dtype=torch.int32, device=dev),
        kit=torch.zeros((), dtype=torch.int64, device=dev))
    bufs = _Buffers(c, ("p", "rr", "beta", "dxx", "flag"), graph)
    mon = _monitor(monitor_every, maxits, dt, dev)
    read = _reader(mon)
    runner = BlockRunner(dev, graph, stats)

    def body(check: bool):
        active = c.flag == ok
        p, t, ptap = coupled_step(r, c.p, c.beta)
        # indefiniteness witness: for SPD A, p'Ap > 0 whenever r != 0;
        # p'Ap == 0 with rr == 0 is exact convergence (alpha = 0, no flag)
        indefinite = (ptap < 0) | ((ptap == 0) & (c.rr > 0))
        safe = ptap > 0
        alpha = torch.where(safe & active,
                            c.rr / torch.where(safe, ptap, one), zero)
        rr_new, pp = update(x, r, p, t, alpha)
        if track_diff:
            c.dxx = torch.where(active, alpha * alpha * pp, c.dxx)
        c.kit += 1
        # a finished system's history stops advancing (NaN past its exit;
        # a 1-D solve's count ends its history instead)
        hist.index_copy_(hdim, c.kit.reshape(1), (
            torch.where(active, rr_new, nan) if batched
            else rr_new).unsqueeze(-1))
        status = torch.where(indefinite, brk, ok)
        if check:
            converged = met(rr_new)
            if track_diff:
                converged = converged | ((ds > 0) & (c.dxx < ds))
            status = torch.where(indefinite, brk,
                                 torch.where(converged, conv_c, ok))
            if guard:
                nonfin = ~(torch.isfinite(rr_new) & torch.isfinite(ptap))
                status = torch.where(nonfin, fault, status)
        c.flag = torch.where(active, status, c.flag)
        c.kdev += active
        beta = rr_new / torch.where(c.rr == 0, one, c.rr)
        if batched:
            # a finished system's next direction is its frozen r: finite
            # and fixed, and never used, since its alpha is 0
            beta = torch.where(c.flag == ok, beta, zero)
        c.beta = beta
        c.rr = torch.where(active, rr_new, c.rr)
        c.p = p
        if mon is not None:
            mon.put(c.kit, c.rr.amax() if batched else c.rr,
                    active.any() if batched else active)

    k = 0
    running = maxits > 0 and bool((c.flag == ok).any())
    while running:
        n, check, _ = block_plan(k, maxits, check_every, segment)

        def block(n=n, check=check):
            for i in range(n):
                body(check and i == n - 1)

        runner.run((n, check), bufs.block(block))
        k += n
        running = k < maxits and read((c.flag == ok).any(), k)
    if mon is not None:
        mon.flush(k)
    # tolerance met at exit IS convergence, whatever the flag: with
    # check_every > 1 the loop may pass the unobserved convergence point
    flag = torch.where(met(c.rr), conv_c, c.flag)
    if batched:
        return x, c.kdev, c.rr, c.dxx, flag, rr0, hist
    return x, int(c.kdev), c.rr, c.dxx, int(flag), rr0, hist


def cg_pipelined_while(matvec, dot2, b, x0, stop2, maxits: int,
                       check_every: int = 1, replace_every: int = 0,
                       certify: bool = True, iter_step=None,
                       guard: bool = False, segment: int = 0,
                       monitor_every: int = 0, graph: bool = False,
                       stats=None):
    """Pipelined CG (Ghysels/Vanroose; ref acg/cgcuda.c:1676-1788) with
    ONE fused reduction point per iteration: ``dot2(a1, b1, a2, b2)``
    returns (a1·b1, a2·b2).  The port of
    ``acg_tpu.solvers.loops.cg_pipelined_while`` for one right-hand side.

    Returns ``(x, k, gamma, flag, gamma0, hist)``: ``k`` and ``flag``
    ints (flag 0 running, 1 converged, 3 non-finite caught by the guard),
    ``gamma``/``gamma0`` 0-d tensors (|r|² at exit and at x0), ``hist``
    the ``(maxits+1,)`` history of the recurred gamma, NaN past ``k``,
    holding the true residual at certification points.

    ``iter_step(z, r, p, w, s, x, alpha, beta, w_out) -> (z', p', s',
    x', r', w', gamma, delta)``, when given, runs the WHOLE body (q = A
    w, the 6-vector update, both dots) as one kernel, z, p, s, x and r in
    their buffers and w' into ``w_out``; it requires ``replace_every ==
    0``.  The loop keeps two w buffers and alternates them, so a block of
    an odd length ends with w in the other buffer: a block's key carries
    the parity it starts on.  Otherwise the body is open-coded:
    ``matvec``, the in-place 6-vector update, ``dot2``, and every
    ``replace_every`` iterations (a host-known schedule, where a block
    ends) r = b - A x, w = A r, s = A p, z = A s are recomputed from
    their definitions.

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

    ``segment``, ``monitor_every``, ``graph``, ``stats``: as
    :func:`cg_while`.  A (B, n) ``b`` runs the batched loop
    (:func:`_cg_pipelined_batched`), which takes the open-coded body
    only: ``iter_step`` is not batched."""
    if iter_step is not None and replace_every > 0:
        raise ValueError("iter_step requires replace_every == 0")
    if b.dim() == 2:
        if iter_step is not None:
            raise ValueError("iter_step (the single-kernel pipelined "
                             "iteration) is not batched; callers gate it "
                             "off for multi-RHS solves")
        return _cg_pipelined_batched(matvec, dot2, b, x0, stop2, maxits,
                                     check_every, replace_every, certify,
                                     guard, segment, monitor_every, graph,
                                     stats)
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

    def replace_state():
        """r, w, s, z recomputed from their definitions, into their
        buffers."""
        torch.sub(b, matvec(c.x), out=c.r)
        _keep(c.w, matvec(c.r))
        _keep(c.s, matvec(c.p))
        _keep(c.z, matvec(c.s))

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

    def advance(gamma_new, delta_new, gamma, alpha, bad):
        """Record this step's gamma and form the next step's
        coefficients."""
        hist.index_copy_(0, c.kit.reshape(1), gamma_new.reshape(1))
        return coefficients(gamma_new, delta_new, gamma, alpha, bad)

    fresh = torch.ones((), dtype=torch.bool, device=dev)
    alpha0, beta0, bad0 = coefficients(gamma0, delta0, gamma0, zero, fresh)
    hist = torch.full((maxits + 1,), float("nan"), dtype=dt, device=dev)
    hist[0] = gamma0
    # the carried state: the vectors move in their buffers (w between two
    # under iter_step); the scalars are rebound by a block and (graph)
    # copied back at its end.  a_i, bad_i, g_i: the coefficients and
    # gamma a step started from (a redo after certification needs them)
    c = types.SimpleNamespace(
        x=x0.clone(), p=torch.zeros_like(b), s=torch.zeros_like(b),
        z=torch.zeros_like(b), r=r, w=w, gamma=gamma0.clone(),
        delta=delta0.clone(), alpha=alpha0, beta=beta0, bad=bad0,
        a_i=zero.clone(), bad_i=fresh.clone(), g_i=gamma0.clone(),
        gn=gamma0.clone(), dn=delta0.clone(), cand=~fresh,
        kit=torch.zeros((), dtype=torch.int64, device=dev))
    names = ("a_i", "bad_i", "g_i", "gn", "dn", "cand", "alpha", "beta",
             "bad", "gamma", "delta")
    wbuf = [w, torch.zeros_like(b)] if iter_step is not None else None
    running = ~met(gamma0)
    if guard:
        # what the loop returns, frozen at the first non-finite pair
        nan = torch.full((), float("nan"), dtype=dt, device=dev)
        cert_c = (fresh.clone(), ~fresh)    # certified: True, False
        c.alive = finite(gamma0, delta0)
        c.x_keep = c.x.clone()
        c.kdev = torch.zeros((), dtype=torch.int32, device=dev)
        c.cert_t = fresh.clone()
        names += ("cert_t", "alive")
        running = running & c.alive
    bufs = _Buffers(c, names, graph)
    mon = _monitor(monitor_every, maxits, dt, dev)
    read = _reader(mon)
    runner = BlockRunner(dev, graph, stats)

    def head(check: bool, rep: bool, w_out):
        """A step up to its exit test: the update, a scheduled
        replacement, the dots; without the guard the speculative
        coefficients of the next step (redone after a certification)."""
        alpha, beta, bad = c.alpha, c.beta, c.bad
        c.a_i, c.bad_i, c.g_i = alpha, bad, c.gamma
        if iter_step is not None:
            out = iter_step(c.z, c.r, c.p, c.w, c.s, c.x, alpha, beta,
                            w_out)
            for name, v in zip(("z", "p", "s", "x", "r"), out[:5]):
                _keep(getattr(c, name), v)
            _keep(w_out, out[5])
            c.w = w_out
            gamma_new, delta_new = out[6], out[7]
        else:
            pipelined_update_(matvec(c.w), c.w, c.z, c.r, c.p, c.s, c.x,
                              alpha, beta)
            if rep:
                replace_state()
            gamma_new, delta_new = dot2(c.r, c.r, c.w, c.r)
        c.kit += 1
        if certify and check:
            c.cand = met(gamma_new)
        c.gn, c.dn = gamma_new, delta_new
        if not guard:
            c.alpha, c.beta, c.bad = advance(gamma_new, delta_new, c.gamma,
                                             alpha, bad)
            c.gamma, c.delta = gamma_new, delta_new
            if mon is not None:
                mon.put(c.kit, gamma_new)

    def tail(certified: bool):
        """The guard's end of a step: freeze what the loop returns at the
        first non-finite pair."""
        live = c.alive
        torch.where(live, c.x, c.x_keep, out=c.x_keep)
        c.cert_t = torch.where(live, cert_c[0] if certified else cert_c[1],
                               c.cert_t)
        gamma_new = torch.where(live, c.gn, c.gamma)
        delta_new = torch.where(live, c.dn, c.delta)
        c.alpha, c.beta, c.bad = advance(
            torch.where(live, gamma_new, nan), delta_new, c.gamma, c.a_i,
            c.bad_i)
        c.kdev += live
        c.alive = live & finite(gamma_new, delta_new)
        c.gamma, c.delta = gamma_new, delta_new
        if mon is not None:
            mon.put(c.kit, gamma_new, live)

    k = 0
    parity = 0
    certified = True                       # gamma0 is a true residual
    running = maxits > 0 and bool(running)
    while running:
        n, check, rep = block_plan(k, maxits, check_every, segment,
                                   replace_every)
        cert = certify and check
        # with the guard, the step that waits on the certification read
        # ends after that read
        late = guard and cert

        def block(n=n, check=check, rep=rep, parity=parity, late=late):
            for i in range(n):
                last = i == n - 1
                head(check and last, rep and last,
                     wbuf[(parity + i + 1) % 2] if wbuf else None)
                if guard and not (late and last):
                    tail(rep and last)

        bufs.commit()
        runner.run((n, check, rep, parity), bufs.block(block))
        k += n
        if wbuf:
            parity = (parity + n) % 2
        cand = False
        if cert:
            # this step's monitor value waits for the redo below
            cand = read((c.cand & c.alive) if guard else c.cand, k - 1)
            if cand and not rep:
                replace_state()
                gamma_new, delta_new = dot2(c.r, c.r, c.w, c.r)
                c.gn, c.dn = gamma_new, delta_new
                if not guard:
                    c.alpha, c.beta, c.bad = advance(
                        gamma_new, delta_new, c.g_i, c.a_i, c.bad_i)
                    c.gamma, c.delta = gamma_new, delta_new
                    if mon is not None:
                        mon.put(c.kit, gamma_new)
        certified = cand or rep
        if late:
            tail(certified)
        if k >= maxits:
            break
        if check:
            # a certified candidate exits on its true gamma
            stop = cand and (rep or read(met(c.gamma), k))
            running = not stop and (not guard or read(c.alive, k))
    if mon is not None:
        mon.flush(k)
    x, gamma, delta = c.x, c.gamma, c.delta
    if guard:
        x, k = c.x_keep, int(c.kdev)
    if certify:
        # the maxits door, off the check schedule, can leave an
        # uncertified gamma below the threshold: certify that one too
        # (|b - A x|^2; JAX also forms w = A r, which gamma does not use)
        need = ((met(gamma) & ~c.cert_t) if guard
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


def _cg_pipelined_batched(matvec, dot2, b, x0, stop2, maxits: int,
                          check_every: int, replace_every: int,
                          certify: bool, guard: bool, segment: int = 0,
                          monitor_every: int = 0, graph: bool = False,
                          stats=None):
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
    all are done.  Blocks as in :func:`cg_while`; the step that waits on
    a certification read ends after it."""
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

    fresh = torch.ones_like(gamma0, dtype=torch.bool)
    hist = torch.full(gamma0.shape + (maxits + 1,), float("nan"), dtype=dt,
                      device=dev)
    hist[:, 0] = gamma0
    # systems converged at x0 are done before the first iteration
    c = types.SimpleNamespace(
        x=x0.clone(), p=torch.zeros_like(b), s=torch.zeros_like(b),
        z=torch.zeros_like(b), r=r, w=w, gamma=gamma0.clone(),
        delta=delta0.clone(), gamma_prev=gamma0.clone(),
        alpha_prev=torch.zeros_like(gamma0), fresh=fresh,
        certified=fresh.clone(),             # gamma0 is a true residual
        done=met(gamma0),
        ksys=torch.zeros(gamma0.shape, dtype=torch.int32, device=dev),
        kit=torch.zeros((), dtype=torch.int64, device=dev),
        gn=gamma0.clone(), dn=delta0.clone(), active=~fresh, cand=~fresh,
        alpha_i=torch.zeros_like(gamma0), bad_i=fresh.clone())
    names = ("gn", "dn", "active", "cand", "alpha_i", "bad_i", "gamma",
             "delta", "gamma_prev", "alpha_prev", "fresh", "certified",
             "done", "ksys")
    if guard:
        c.x_old = torch.zeros_like(b)
    bufs = _Buffers(c, names, graph)
    mon = _monitor(monitor_every, maxits, dt, dev)
    read = _reader(mon)
    runner = BlockRunner(dev, graph, stats)

    def head(check: bool, rep: bool):
        """A step up to its exit candidates."""
        active = ~c.done
        beta = torch.where(c.fresh, zero, c.gamma / torch.where(
            c.gamma_prev == 0, one, c.gamma_prev))
        denom = torch.where(c.fresh, c.delta, c.delta - beta * c.gamma
                            / torch.where(c.alpha_prev == 0, one,
                                          c.alpha_prev))
        # unusable denominator -> restart: freeze this step, re-derive the
        # directions from r, w on the next one
        bad = (denom <= 0) | (~c.fresh & (c.gamma_prev == 0))
        alpha = torch.where(bad, zero, c.gamma / torch.where(bad, one, denom))
        stop = bad | c.done
        if guard:
            _keep(c.x_old, c.x)
        pipelined_update_(matvec(c.w), c.w, c.z, c.r, c.p, c.s, c.x,
                          torch.where(c.done, zero, alpha),
                          torch.where(stop, zero, beta))
        if rep:
            for name, v in zip(("r", "w", "s", "z"), replace_state(c.x, c.p)):
                _keep(getattr(c, name), v)
        c.gn, c.dn = dot2(c.r, c.r, c.w, c.r)
        c.kit += 1
        c.cand = (met(c.gn) & active if certify and check
                  else torch.zeros_like(active))
        c.active, c.alpha_i, c.bad_i = active, alpha, bad

    def certify_candidates():
        """A just-replaced gamma IS the true residual; else the
        candidates take the replacement, blended in."""
        rc, wc, sc, zc = replace_state(c.x, c.p)
        gc, dc = dot2(rc, rc, wc, rc)
        m = c.cand[:, None]
        for new, old in ((rc, c.r), (wc, c.w), (sc, c.s), (zc, c.z)):
            torch.where(m, new, old, out=old)
        c.gn = torch.where(c.cand, gc, c.gn)
        c.dn = torch.where(c.cand, dc, c.dn)

    def tail(check: bool, rep: bool):
        """The rest of a step: per-system freezing, history, exit."""
        active = c.active
        if guard:
            torch.where(active[:, None], c.x, c.x_old, out=c.x)
        gamma_new = torch.where(active, c.gn, c.gamma)
        delta_new = torch.where(active, c.dn, c.delta)
        c.gamma_prev = torch.where(active, c.gamma, c.gamma_prev)
        c.alpha_prev = torch.where(active, c.alpha_i, c.alpha_prev)
        c.fresh = torch.where(active, c.bad_i, c.fresh)
        c.certified = torch.where(active, c.cand | rep, c.certified)
        hist.index_copy_(1, c.kit.reshape(1),
                         torch.where(active, gamma_new, nan)[:, None])
        if check:
            # the exit decision per system, on the (certified) gamma
            c.done = c.done | (active & met(gamma_new))
        if guard:
            c.done = c.done | (active & ~(torch.isfinite(gamma_new)
                                          & torch.isfinite(delta_new)))
        c.ksys = torch.where(active, c.kit.to(torch.int32), c.ksys)
        c.gamma, c.delta = gamma_new, delta_new
        if mon is not None:
            mon.put(c.kit, gamma_new.amax(), active.any())

    k = 0
    running = maxits > 0 and not bool(c.done.all())
    while running:
        n, check, rep = block_plan(k, maxits, check_every, segment,
                                   replace_every)
        cert = certify and check

        def block(n=n, check=check, rep=rep, cert=cert):
            for i in range(n):
                last = i == n - 1
                head(check and last, rep and last)
                if not (cert and last):
                    tail(check and last, rep and last)

        bufs.commit()
        runner.run((n, check, rep), bufs.block(block))
        k += n
        if cert:
            if not rep and read(c.cand.any(), k - 1):
                certify_candidates()
            tail(True, rep)
        if k >= maxits:
            break
        if check:
            running = not read(c.done.all(), k)
    if mon is not None:
        mon.flush(k)
    gamma, ksys = c.gamma, c.ksys
    if certify:
        # the maxits door, off the check schedule, can leave an
        # uncertified gamma below the threshold: certify those too
        need = met(gamma) & ~c.certified
        if bool(need.any()):
            rt = b - matvec(c.x)
            g, _ = dot2(rt, rt, rt, rt)
            gamma = torch.where(need, g, gamma)
        # each system's last sample is its certified exit value
        hist[torch.arange(gamma.shape[0], device=dev), ksys.long()] = gamma
        flag = torch.where(met(gamma), _CONVERGED, _OK).to(torch.int32)
    else:
        flag = torch.full(gamma.shape, _OK, dtype=torch.int32, device=dev)
    if guard:
        flag = torch.where(torch.isfinite(gamma) & torch.isfinite(c.delta),
                           flag, _FAULT).to(torch.int32)
    return c.x, ksys, gamma, flag, gamma0, hist


# ---------------------------------------------------------------------------
# s-step CG


def _leja_order(v: np.ndarray) -> np.ndarray:
    """Leja ordering of a shift set along the last axis, rows of a batch
    independently (``acg_tpu.solvers.loops._leja_order``): the
    largest-magnitude point first, then greedily the point maximizing the
    product of distances to those chosen, accumulated as a sum of logs in
    ``v``'s dtype.  The Newton-basis stabilization: monomial-ordered
    shifts lose the conditioning they exist to buy."""
    v = np.asarray(v)
    s = v.shape[-1]
    if s == 1:
        return v
    tiny = v.dtype.type(1e-30)

    def take(i):
        return np.take_along_axis(v, i[..., None], axis=-1)[..., 0]

    idx = np.argmax(np.abs(v), axis=-1)
    out = [take(idx)]
    picked = np.arange(s) == idx[..., None]
    logprod = np.zeros(v.shape, v.dtype)
    with np.errstate(divide="ignore", invalid="ignore"):
        for _ in range(s - 1):
            logprod = logprod + np.log(np.abs(v - out[-1][..., None]) + tiny)
            idx = np.argmax(np.where(picked, -np.inf, logprod), axis=-1)
            out.append(take(idx))
            picked = picked | (np.arange(s) == idx[..., None])
    return np.stack(out, axis=-1).astype(v.dtype)


def _newton_basis_matrix(shifts: np.ndarray, s: int) -> np.ndarray:
    """The change-of-basis matrix with A V = V B on the first s (P) and
    s-1 (R) columns of the Newton basis block
    (``acg_tpu.solvers.loops._newton_basis_matrix``): the recurrence
    V[j+1] = (A - theta_j) V[j] gives A V[j] = V[j+1] + theta_j V[j], so B
    is the P/R-blocked sub-diagonal of ones plus theta on the diagonal;
    the spill columns are zero.  ``shifts`` ([B,] s) gives ([B,] m, m),
    m = 2s+1."""
    m = 2 * s + 1
    sub = np.zeros((m, m), dtype=shifts.dtype)
    for j in range(s):
        sub[j + 1, j] = 1.0
    for j in range(s - 1):
        sub[s + 2 + j, s + 1 + j] = 1.0
    zero1 = np.zeros(shifts.shape[:-1] + (1,), shifts.dtype)
    theta = np.concatenate([shifts, zero1, shifts[..., : s - 1], zero1],
                           axis=-1)
    return sub + theta[..., :, None] * np.eye(m, dtype=shifts.dtype)


def _history_init(rr0: np.ndarray, maxits: int) -> np.ndarray:
    """The (B, maxits+1) residual-norm² history on the host, NaN past
    what was run, slot 0 = |r0|²."""
    hist = np.full((rr0.shape[0], maxits + 1), np.nan, dtype=rr0.dtype)
    hist[:, 0] = rr0
    return hist


def cg_sstep_while(block_fn, combine_fn, b, x0, p0, rr0, shifts0, stop2,
                   s: int, maxits: int, stats=None, monitor_every: int = 0):
    """s-step (communication-reduced) CG, one Gram reduction per s
    iterations (arXiv:2501.03743; the port of
    ``acg_tpu.solvers.loops.cg_sstep_while``).

    Per block, ``block_fn(x, p, shifts) -> (V, G)`` builds the (2s+1)
    basis on the device: rows 0..s the Newton-shifted P block from p,
    rows s+1..2s the R block from the REPLACED residual r = b - A x (so
    G[s+1, s+1] is the true |b - A x|² every exit stands on), and its Gram
    matrix G = V Vᵀ.  The s inner steps are recurrences on the
    coefficients: every inner product <u, v> with u = u'ᵀV, v = v'ᵀV is
    u'ᵀ G v', and A V is the static :func:`_newton_basis_matrix`.  Here
    they run on the HOST in NumPy, in the vector dtype: G (m² scalars a
    system) is copied down once a block, the inner recurrences, the Ritz
    step (``eigvalsh`` of the s x s Lanczos tridiagonal) and the Leja
    order run there, and the two coefficient vectors go back for the
    combinations ``combine_fn(c, V)``, both from one read of V: x +=
    xcᵀV and p = pcᵀV, skipped for a system that committed nothing.  On
    the card this is one device-to-host copy a block where the JAX loop
    runs a few hundred scalar operations inside its ``while_loop``.

    Exit discipline, as in the JAX loop: convergence is decided only at
    block boundaries on the replaced residual; an inner estimate below
    tolerance pauses that system until the next block certifies it or
    resumes it; a true residual more than 1e4 x |r0|² above (the
    divergence guard), a non-finite Gram, an indefinite quadratic form
    beyond the coefficient-space roundoff floor, or a live block that
    committed nothing flags ``_GRAM_BAD`` with the block rolled back (x
    keeps its last good state), and the wrapper falls back to classic
    CG.  A complete block's Lanczos tridiagonal gives the next block's
    shifts (its Ritz values, Leja-ordered) when they are finite and
    positive.

    ``b``/``x0``/``p0`` are device tensors, (n,) or (B, n), or per-shard
    vectors (``acg_torch.parallel.sharded.ShardVec``, with ``V`` then a
    ``ShardStack`` and ``combine_fn`` applied shard by shard); ``rr0`` and
    ``shifts0`` host arrays ((B,) / (B, s), B = 1 for one system) in the
    vector dtype, ``stop2`` the host (atol², rtol²).  Returns ``(x, kiter,
    rr, flag, hist, shifts)`` with x on the device and the rest host
    arrays of leading axis B, ``hist`` (B, maxits+1) written at each
    system's own iteration cursor.  A ``SolveStats`` given as ``stats``
    counts the blocks and accumulates the host's seconds a block: the
    wait for G, then the rest of the block."""
    batched = b.dim() == 2
    vdt = rr0.dtype
    t = vdt.type
    nsys = rr0.shape[0]
    m = 2 * s + 1
    one, zero = t(1), t(0)
    atol2, rtol2 = stop2
    thresh2 = np.maximum(atol2, rtol2 * rr0)
    any_crit = bool(atol2 > 0 or rtol2 > 0)

    def met(rr):
        return (rr < thresh2) | (any_crit & (rr == 0))

    def hist_put(pos, mask, val):
        sel = np.nonzero(mask)[0]
        hist[sel, pos[sel]] = val[sel]

    x, p = x0.clone(), p0
    rr, shifts = rr0.copy(), shifts0.copy()
    kiter = np.zeros(nsys, np.int64)
    flag = np.zeros(nsys, np.int64)
    hist = _history_init(rr0, maxits)
    e_p = np.zeros((nsys, m), vdt)
    e_p[:, 0] = 1
    e_r = np.zeros((nsys, m), vdt)
    e_r[:, s + 1] = 1
    eps = t(4.0 * m * np.finfo(vdt).eps)
    eye = np.eye(s, dtype=vdt)
    with np.errstate(all="ignore"):
        while np.any((flag == _OK) & (kiter < maxits)):
            V, G = block_fn(x, p, shifts if batched else shifts[0])
            t_wait = time.perf_counter()
            G = G.cpu().numpy().reshape(nsys, m, m)
            t_host = time.perf_counter()
            rr_true = G[:, s + 1, s + 1]
            gfin = np.all(np.isfinite(G), axis=(-2, -1))
            # the divergence guard: an ill-conditioned basis can commit
            # garbage for blocks while every coefficient quantity stays
            # finite; the block boundary's true residual catches it
            difn = gfin & ~met(rr_true) & (rr_true > t(1e4) * rr0)
            active0 = flag == _OK
            flag = np.where(active0 & (~gfin | difn), _GRAM_BAD,
                            np.where(active0 & met(rr_true), _CONVERGED, flag))
            hist_put(kiter, active0 & gfin, rr_true)
            kmon = int(np.max(kiter))
            if monitor_every > 0 and kmon % monitor_every == 0:
                emit_residual_line(kmon, np.max(np.where(active0, rr_true,
                                                         rr)))
            active = flag == _OK
            Bmat = _newton_basis_matrix(shifts, s)
            kiter0 = kiter.copy()
            pc, rc = e_p.copy(), e_r.copy()
            xc = np.zeros_like(pc)
            rr_j = rr_true.copy()
            conv_est = np.zeros(nsys, bool)
            bad = np.zeros(nsys, bool)
            allok = active.copy()
            # quadratic forms c'Gc carry absolute error ~ m eps max|G| |c|²: a
            # tiny negative within it is cancellation at the attainable
            # floor (the system pauses), not an indefinite Gram
            gmax = np.max(np.abs(G), axis=(-2, -1))
            alphas, betas = [], []
            for _ in range(s):
                w = np.einsum("bij,bj->bi", Bmat, pc)
                denom = np.sum(pc * np.einsum("bij,bj->bi", G, w), axis=-1)
                step = active & ~bad & ~conv_est & (kiter < maxits)
                zerofrozen = step & (rr_j == 0)
                attempt = step & (rr_j > 0)
                floor_p = eps * gmax * np.sum(pc * pc, axis=-1)
                benign_d = (attempt & (denom <= 0) & np.isfinite(denom)
                            & (np.abs(denom) <= floor_p))
                conv_est = conv_est | benign_d
                indef = attempt & ~benign_d & ((denom <= 0)
                                               | ~np.isfinite(denom))
                bad = bad | indef
                do = attempt & ~indef & ~benign_d
                alpha = np.where(do, rr_j / np.where(do, denom, one), zero)
                xc2 = xc + alpha[:, None] * pc
                rc2 = rc - alpha[:, None] * w
                rr_n = np.sum(rc2 * np.einsum("bij,bj->bi", G, rc2), axis=-1)
                floor_r = eps * gmax * np.sum(rc2 * rc2, axis=-1)
                rr_n = np.where((rr_n < 0) & (np.abs(rr_n) <= floor_r), zero,
                                rr_n)
                ok2 = np.isfinite(rr_n) & (rr_n >= 0)
                bad = bad | (do & ~ok2)
                commit = do & ok2
                xc = np.where(commit[:, None], xc2, xc)
                rc = np.where(commit[:, None], rc2, rc)
                counted = commit | zerofrozen
                kiter = kiter + counted
                hist_put(kiter, counted, np.where(commit, rr_n, rr_j))
                conv_est = conv_est | (commit & met(rr_n))
                beta = np.where(commit, rr_n / np.where(rr_j == 0, one, rr_j),
                                zero)
                pc = np.where(commit[:, None], rc2 + beta[:, None] * pc, pc)
                alphas.append(alpha)
                betas.append(beta)
                allok = allok & commit
                rr_j = np.where(commit, rr_n, rr_j)
            # a live block that committed nothing would rebuild the same
            # basis forever: the fallback takes over
            changed = kiter > kiter0
            stalled = active & ~changed & (kiter < maxits)
            flag = np.where(active & (bad | stalled), _GRAM_BAD, flag)
            # only committed steps touched xc, so a bad block rolls back; the
            # combinations run only where a step committed (0 x inf = NaN)
            moved = np.nonzero(changed)[0]
            if moved.size:
                # every system's (xc, pc) in one copy: a copy waits for the
                # stream, so one a system would wait out each combination
                cdev = torch.from_numpy(np.stack([xc[moved], pc[moved]],
                                                 axis=1)).to(x.device)
            for j, i in enumerate(moved):
                # system i of a batch through ``select``, which shard
                # vectors and basis stacks apply shard by shard
                xi, pi = ((x.select(0, i), p.select(0, i)) if batched
                          else (x, p))
                # both combinations from one read of the basis
                xp = combine_fn(cdev[j], V.select(1, i) if batched else V)
                xi.add_(xp.select(0, 0))
                pi.copy_(xp.select(0, 1))
            # on-the-fly Ritz refinement: a complete block's (alpha, beta)
            # is a Lanczos tridiagonal whose eigenvalues shift the next block
            a = np.stack(alphas, axis=-1)
            bt = np.stack(betas, axis=-1)
            a_safe = np.where(a > 0, a, one)
            diag = one / a_safe
            bt_h, a_h = bt[:, : s - 1], a_safe[:, : s - 1]
            diag[:, 1:] += bt_h / a_h
            off = np.sqrt(np.maximum(bt_h, zero)) / a_h
            T = diag[:, :, None] * eye
            idx = np.arange(s - 1)
            T[:, idx, idx + 1] = off
            T[:, idx + 1, idx] = off
            # a non-finite tridiagonal keeps the old shifts, as JAX's NaN
            # eigenvalues do
            valid = allok & np.all(np.isfinite(T), axis=(-2, -1))
            T = np.where(valid[:, None, None], T, eye)
            new_shifts = _leja_order(np.linalg.eigvalsh(T).astype(vdt))
            good = (valid & np.all(np.isfinite(new_shifts), axis=-1)
                    & np.all(new_shifts > 0, axis=-1))
            shifts = np.where(good[:, None], new_shifts, shifts)
            rr = rr_j
            if stats is not None:
                stats.nsstepblocks += 1
                stats.tsstepwait += t_host - t_wait
                stats.tsstephost += time.perf_counter() - t_host
    return x, kiter, rr, flag, hist, shifts


# ---------------------------------------------------------------------------
# depth-l pipelined CG


def _window(b, w: int):
    """w zero vectors shaped like ``b``, as one stack: a (w, [B,] n)
    tensor, or for per-shard vectors their ``window`` (one stack a
    shard)."""
    if isinstance(b, torch.Tensor):
        return torch.zeros((w,) + tuple(b.shape), dtype=b.dtype,
                           device=b.device)
    return b.window(w)


def cg_pipelined_deep_while(matvec, dots, combine_fn, dot, b, x0, stop2,
                            depth: int, shifts, maxits: int,
                            check_every: int = 1, replace_every: int = 0,
                            certify: bool = True, k_start: int = 0,
                            rr0_in=None, flags_in=None, hist_in=None,
                            ksys_in=None, guard: bool = False, fill=None,
                            cert_matvec=None, monitor=None):
    """Depth-l pipelined CG, l reductions in flight: ONE pipeline segment
    (dispatch) of the port of ``acg_tpu.solvers.loops``
    ``cg_pipelined_deep_while`` (p(l)-CG, Cornelis/Cools/Vanroose
    arXiv:1801.04728).

    The iteration runs on the shifted-Newton basis z_j = p_l(A) v_{j-l};
    each body issues ONE SpMV and ONE dot block ``dots(Z, z_new)`` (the
    2l+1 inner products of z_new with the window, a ([B,] 2l+1) result in
    the window's storage order) and consumes the block issued l bodies
    before: it finalizes column c = t+1 of the banded basis change G by
    forward substitution, reads (gamma_t, delta_t) off T G = G B,
    recovers the Lanczos vector v_c and advances x by the D-Lanczos
    update, whose residual estimate comes free.  ``combine_fn(c, V)``
    forms sum_i c_i V_i (v_c's correction) in one product.  The window of
    z (2l+1 vectors) and of v (the 2l the bodies read) are rings: a body
    writes its new vector over the oldest and advances the head, so no
    vector is copied to slide a window.

    The scalars stay on the device as 0-d (or (B,)) tensors, decided
    with tensor ops as the JAX body decides them; the host reads the flag
    only every ``check_every`` bodies (and at ``maxits`` or the
    ``replace_every`` bound), one body late on every device (on the card
    the copy of a check point's flag overlaps the next body).  Between
    reads a system that breaks down or claims convergence FREEZES (every
    update is selected on its commit), so the host's body count equals
    the JAX count k while any system is live, and the extra bodies
    change nothing.

    DISPATCH PROTOCOL (restart = residual replacement): the entry
    recomputes r = b - A x; the segment stops after ``replace_every``
    updates, on a claimed exit, or at ``maxits``; the certifier after the
    loop derives the TRUE residual and only a true value below the
    threshold flags ``_CONVERGED``; ``drift`` marks an estimate it
    refuted.  ``k_start`` (host int), ``rr0_in``, ``flags_in``,
    ``hist_in`` and ``ksys_in`` carry a solve across dispatches (None on
    the first).  A non-positive LDL pivot or Cholesky diagonal freezes
    the system with ``_BREAKDOWN`` and no commit; ``guard`` flags a
    non-finite estimate or pivot ``_FAULT`` at the check points.

    ``fill(zs)`` writes the fill chain z_{j+1} = (A - sigma_j) z_j into
    ``zs[1:]`` (the l ring slots after ``zs[0]`` = z_0); None runs it
    through ``matvec``, and the distributed caller passes the deep-ghost
    chain instead (one depth-l exchange feeding l extended SpMVs,
    ``acg_torch/parallel/deep.py``).  ``cert_matvec`` is the operator of
    the entry residual and of the certifier (None: ``matvec``); the
    distributed caller passes the full-width exchange there when the
    loop's halo runs a compressed wire.  ``b`` and ``x0`` may be per-shard
    vectors (``ShardVec``), the rings then one stack a shard
    (``ShardStack``), which ``dots`` and ``combine_fn`` read shard by
    shard.

    ``monitor`` (a ``LoopMonitor``, one for the whole solve) takes each
    live body's report, the update count k + 1 and the residual estimate
    (a batch's worst system), as the JAX body passes them; the host reads
    them with the flag at the dispatch's end.  A body that committed
    nothing reports k + 1 again in the next dispatch, as in the JAX loop.

    ``shifts`` ([B,] l) is a device tensor.  Returns ``(x, kret, rr, flag,
    rr0, hist, k, more, drift)``: ``rr`` the certified |r|² (or the last
    estimate without ``certify``), ``k`` the host update count to pass
    back as the next ``k_start``, ``more`` whether a system can go on;
    ``kret`` is ``k`` for one system, the per-system counts (B,) for a
    batch."""
    batched = b.dim() == 2
    l, w = depth, 2 * depth + 1
    if l < 2:
        raise ValueError("cg_pipelined_deep_while requires depth >= 2 "
                         "(depth 1 is cg_pipelined_while)")
    dev, dt = b.device, b.dtype
    bc = (lambda v: v[:, None]) if batched else (lambda v: v)
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    atol2, rtol2 = stop2
    k0 = int(k_start)

    cmv = matvec if cert_matvec is None else cert_matvec
    r = b - cmv(x0)
    eta2 = dot(r, r)
    rr0 = eta2 if rr0_in is None else torch.where(rr0_in > 0, rr0_in, eta2)
    thresh2 = torch.maximum(atol2, rtol2 * rr0)
    any_crit = bool(atol2 > 0) or bool(rtol2 > 0)

    def met(g):
        m = g < thresh2
        return (m | (g == 0)) if any_crit else m

    def code(c):
        return torch.tensor(c, dtype=torch.int32, device=dev)

    ok_c, conv_c, brk_c, fault_c = (code(c) for c in
                                    (_OK, _CONVERGED, _BREAKDOWN, _FAULT))

    eta = torch.sqrt(eta2)
    inv_eta = torch.where(eta2 > 0, one / torch.where(eta2 > 0, eta, one),
                          zero)
    # the z window, a ring of 2l+1 slots: z_{-l}..z_l after the fill
    # chain z_{j+1} = (A - sigma_j) z_j; z_{<0} are zero rows, so their
    # dots come out exactly 0 (the band mask, for free)
    if fill is None:
        def fill(zs):
            for j in range(l):
                torch.addcmul(matvec(zs[j]), bc(shifts[..., j]), zs[j],
                              value=-1, out=zs[j + 1])

    Z = _window(b, w)
    torch.mul(r, bc(inv_eta), out=Z[l])
    fill([Z[l + j] for j in range(l + 1)])
    # the first l dot blocks: D_j = (z_{j+1-2l+a}, z_{j+1}), a = 0..2l
    dbuf = []
    for j in range(l):
        Dz = dots(Z, Z[l + j + 1])              # (z_i, z_{j+1}), i = -l..l
        pad = torch.zeros(Dz.shape[:-1] + (l - j - 1,), dtype=dt,
                          device=dev)
        dbuf.append(torch.cat([pad, Dz[..., : j + l + 2]], dim=-1))
    hz = 0                                       # the ring's oldest slot
    # the v window, a ring of the 2l vectors the bodies read: v_0 = z_0
    Vr = _window(b, w - 1)
    Vr[w - 2].copy_(Z[l])
    hv = 0
    sshape = tuple(eta2.shape)
    G = torch.zeros(sshape + (w, w), dtype=dt, device=dev)
    G[..., w - 1, w - 1] = 1                     # g_{0,0} = 1
    gbuf = [torch.zeros(sshape, dtype=dt, device=dev) for _ in range(l)]
    dlbuf = [torch.zeros(sshape, dtype=dt, device=dev) for _ in range(l)]

    flag = (torch.zeros(sshape, dtype=torch.int32, device=dev)
            if flags_in is None else flags_in.to(torch.int32))
    # the entry residual is true by construction: meeting the threshold
    # here is certified convergence
    flag = torch.where((flag == ok_c) & met(eta2), conv_c, flag)
    est = torch.zeros(sshape, dtype=torch.bool, device=dev)
    if k0 == 0 or hist_in is None:
        hist = torch.full(sshape + (maxits + 1,), float("nan"), dtype=dt,
                          device=dev)
        hist[..., 0] = rr0
    else:
        hist = hist_in
    if batched:
        ksys = (torch.zeros(sshape, dtype=torch.int32, device=dev)
                if ksys_in is None else ksys_in.to(torch.int32))
    kdev = torch.tensor(k0, dtype=torch.int32, device=dev)
    if monitor is not None:
        monitor.emitted = monitor.read_hi = k0
    x = x0.clone()
    q = torch.zeros_like(b)
    d_prev = torch.zeros(sshape, dtype=dt, device=dev)
    zeta_prev = torch.zeros(sshape, dtype=dt, device=dev)
    rr_est = eta2

    def zlog(p):
        """The z window's entry p (0 = oldest)."""
        return Z[(hz + p) % w]

    def live_t():
        lv = (flag == ok_c) & ~est
        return lv.any() if batched else lv

    # the host reads a check point's flag one body late, on every device:
    # the next body is a no-op for a frozen system.  On the card the flag
    # goes through a pinned copy and an event, so its copy overlaps that
    # body and the device never waits for the host to launch
    lag = torch.empty((), dtype=torch.bool, pin_memory=True) \
        if dev.type == "cuda" else None

    def post(v):
        """Hand a check point's flag ``v`` to the host."""
        if lag is None:
            return v
        lag.copy_(v, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        return ev

    def read(p):
        """The flag that ``post`` handed over, on the host."""
        if lag is None:
            return bool(p)
        p.synchronize()
        return bool(lag)

    pending = None

    k = k0
    running = k < maxits and (replace_every <= 0 or k - k0 < replace_every)
    running = running and bool(live_t())
    while running:
        t = k - k0                       # x-update index this dispatch
        active = (flag == ok_c) & ~est

        # 1. pop the l-old block and finalize column c = t+1 of G
        D = dbuf.pop(0)
        Gr = torch.zeros_like(G)
        Gr[..., : w - 1, : w - 1] = G[..., 1:, 1:]
        col = []
        for a in range(w - 1):
            acc = D[..., a]
            for kk in range(a):
                acc = acc - col[kk] * Gr[..., kk, a]
            gaa = Gr[..., a, a]
            ok = gaa != 0                # rows m < 0 carry zeros: g = 0
            col.append(torch.where(ok, acc / torch.where(ok, gaa, one),
                                   zero))
        gcc2 = D[..., w - 1]
        for kk in range(w - 1):
            gcc2 = gcc2 - col[kk] * col[kk]
        good_g = gcc2 > 0                # the Cholesky diagonal stays SPD
        gcc = torch.sqrt(torch.clamp(gcc2, min=0))
        colv = torch.stack(col, dim=-1)
        Gr[..., : w - 1, w - 1] = colv
        Gr[..., w - 1, w - 1] = gcc
        G = Gr

        # 2. the Lanczos coefficients at t from T G = G B: sigma-based
        # while the fill polynomial's degree still grows, then recurrence
        if t < l:
            base, mult = shifts[..., t], one
        else:
            base, mult = gbuf[0], dlbuf[0]
        d_tm1 = dlbuf[l - 1]
        gii = G[..., w - 2, w - 2]
        gii_s = torch.where(gii != 0, gii, one)
        gam_t = base + (col[w - 2] * mult - d_tm1 * G[..., w - 3, w - 2]) \
            / gii_s
        del_t = gcc * mult / gii_s
        gcc_s = torch.where(gcc != 0, gcc, one)
        # sum_a g_{a,c} v_a over the v ring in order, for v_c below
        vsum = combine_fn(torch.roll(colv, hv, dims=-1), Vr)

        # 3. the D-Lanczos x-update at t (its residual estimate is free)
        if t == 0:
            lam, zeta = torch.zeros_like(d_prev), eta
        else:
            lam = d_tm1 / torch.where(d_prev != 0, d_prev, one)
            zeta = -lam * zeta_prev
        dd = gam_t - d_tm1 * lam
        q_new = torch.addcmul(Vr[(hv + w - 2) % (w - 1)], bc(lam), q,
                              value=-1)
        dd_s = torch.where(dd != 0, dd, one)
        x_new = torch.addcmul(x, bc(zeta / dd_s), q_new)
        rr_new = (del_t * zeta / dd_s) ** 2
        bad = (dd <= 0) | ~good_g
        commit = active & ~bad
        x = torch.where(bc(commit), x_new, x)
        q = torch.where(bc(commit), q_new, q)
        d_prev = torch.where(commit, dd, d_prev)
        zeta_prev = torch.where(commit, zeta, zeta_prev)
        rr_est = torch.where(commit, rr_new, rr_est)
        flag = torch.where(active & bad, brk_c, flag)
        at_check = (k + 1) % check_every == 0
        if guard and at_check:
            nonfin = ~(torch.isfinite(rr_new) & torch.isfinite(gcc2))
            flag = torch.where(active & nonfin, fault_c, flag)
        if at_check:
            est = est | (commit & met(rr_new))
        if monitor is not None:
            monitor.put(kdev + 1, rr_est.amax() if batched else rr_est,
                        active.any() if batched else active)
        kdev = kdev + (commit.any() if batched else commit)
        if batched:
            hist[:, k + 1] = torch.where(commit, rr_new, nan)
            ksys = torch.where(commit, k + 1, ksys)
        else:
            hist[k + 1] = torch.where(commit, rr_new, hist[k + 1])

        # v_c = (z_c - sum_a g_{a,c} v_a) / g_{c,c} takes the v ring's
        # oldest slot, which nothing reads from here on
        v_c = torch.sub(zlog(l + 1), vsum, out=Vr[hv])
        v_c.mul_(bc(one / gcc_s))
        hv = (hv + 1) % (w - 1)

        # 4. ONE SpMV and ONE dot block; the new z takes the oldest slot
        z_top, z_prev = zlog(w - 1), zlog(w - 2)
        c_s = torch.where(del_t != 0, del_t, one)
        wv = matvec(z_top)
        wv.addcmul_(bc(gam_t), z_top, value=-1)
        wv.addcmul_(bc(d_tm1), z_prev, value=-1)
        z_new = torch.mul(wv, bc(one / c_s), out=Z[hz])
        hz = (hz + 1) % w
        dbuf.append(torch.roll(dots(Z, z_new), -hz, dims=-1))
        gbuf = gbuf[1:] + [gam_t]
        dlbuf = dlbuf[1:] + [del_t]
        k += 1
        if k >= maxits or (replace_every > 0 and k - k0 >= replace_every):
            break
        if pending is not None:
            running, pending = read(pending), None
            if not running:
                break
        if at_check:
            pending = post(live_t())
    # host and device counts agree while a system is live; the extra
    # bodies a frozen system ran between reads committed nothing
    k = int(kdev)
    touched = flag == ok_c
    if certify:
        # TRUE-residual certification, once a dispatch: only a fresh
        # |b - A x|² below the threshold flags _CONVERGED
        rt = b - cmv(x)
        rr_true = dot(rt, rt)
        met_t = met(rr_true)
        flag = torch.where(touched & met_t, conv_c, flag)
        drift = touched & est & ~met_t
        rr_ret = torch.where(touched, rr_true, rr_est)
        if batched:
            rows = torch.arange(ksys.shape[0], device=dev)
            kk = ksys.long()
            hist[rows, kk] = torch.where(touched, rr_true, hist[rows, kk])
        else:
            hist[k] = torch.where(touched, rr_true, hist[k])
    else:
        drift = torch.zeros(sshape, dtype=torch.bool, device=dev)
        rr_ret = rr_est
    more_sys = (flag == ok_c) & (k < maxits)
    more = (bool(more_sys.any()) if monitor is None
            else monitor.read(more_sys.any(), k + 1))
    kret = ksys if batched else k
    return x, kret, rr_ret, flag, rr0, hist, k, more, drift
