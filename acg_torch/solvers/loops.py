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
reads (``acg_torch/obs/monitor.py``).  The s-step and depth-l pipelined
loops run in blocks the same way: their coefficient work is one kernel a
block (``ops/sstep_coeffs.py``) or a body (``ops/deep_coeffs.py``) over
buffers updated in place.

A loop's state (:func:`cg_loop`, :func:`cg_pipelined_loop`,
:func:`deep_buffers`) is made once, buffers, thresholds and block runner,
and runs solve after solve: :func:`cg_while` and
:func:`cg_pipelined_while` are one solve on a state of their own, and
the serve layer's resident solves (``solvers/cg.py`` ``aot_step``) keep
theirs, with its captures.

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
from acg_torch.ops.deep_coeffs import NCO, deep_coeffs
from acg_torch.ops.sstep_coeffs import read_status, sstep_coeffs
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

    def reset(self) -> None:
        """Every name back on its buffer: a loop that runs solve after
        solve starts each from its buffers."""
        for n in self.names:
            setattr(self.carry, n, self.bufs[n])

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


def _sys_shape(b) -> tuple:
    """The per-system shape of the loop's scalars: () for one system,
    (B,) for a (B, n) batch (``b`` a tensor or per-shard vectors)."""
    return tuple((b if isinstance(b, torch.Tensor) else b[0]).shape[:-1])


def _fill(shape, v, dtype, dev):
    return torch.full(shape, v, dtype=dtype, device=dev)


def cg_while(matvec, dot, b, x0, stop2, diffstop, maxits: int,
             track_diff: bool, check_every: int = 1, coupled_step=None,
             guard: bool = False, update=None, segment: int = 0,
             monitor_every: int = 0, graph: bool = False, stats=None):
    """Classic CG (ref acg/cg.c:534-637 / acg/cgcuda.c:845-1020): one
    solve on a loop of its own (:func:`cg_loop`, then its ``run``).

    Returns ``(x, k, rr, dxx, flag, rr0, hist)``: ``x`` the iterate,
    ``k`` the iteration count (int), ``rr``/``dxx``/``rr0`` 0-d tensors
    (|r|², |dx|², |r0|²), ``flag`` an int (0 running, 1 converged, 2
    breakdown, 3 non-finite caught by the guard), ``hist`` the
    ``(maxits+1,)`` |r_k|² history, NaN past ``k``.  Batched (``b`` of
    shape (B, n); ``dot`` then reduces per system): ``k`` and ``flag``
    are (B,) int32 tensors, the norms (B,) and ``hist`` (B, maxits+1).

    ``stop2`` is the (atol², rtol²) pair of 0-d tensors; the threshold
    max(atol², rtol²·|r0|²) is formed on the device.  ``diffstop`` is a
    float or, batched, a per-system (B,) tensor.  The other arguments
    are :func:`cg_loop`'s; ``stats`` (a ``SolveStats``) gets the block
    counts and the capture seconds."""
    return cg_loop(matvec, dot, b, maxits, track_diff,
                   check_every=check_every, coupled_step=coupled_step,
                   guard=guard, update=update, segment=segment,
                   monitor_every=monitor_every, graph=graph).run(
        x0, stop2, diffstop, stats)


def cg_loop(matvec, dot, b, maxits: int, track_diff: bool,
            check_every: int = 1, coupled_step=None, guard: bool = False,
            update=None, segment: int = 0, monitor_every: int = 0,
            graph: bool = False, capture_first: bool = False):
    """The classic loop's state: every buffer a solve reads and writes
    (x, r, p, the scalars, the flags and counts, the history, the
    threshold, the diff threshold and which systems have a criterion),
    the 0-d constants, the monitor and the block runner, made once for
    right-hand sides shaped like ``b``.  Its ``run(x0, stop2, diffstop,
    stats)`` runs one solve of :func:`cg_while` on them and returns what
    :func:`cg_while` returns (the iterate and the history are the loop's
    buffers, rewritten by the next ``run``).  ``b`` is the loop's
    right-hand side buffer: a solve reads it where ``run`` starts, so a
    caller that keeps the loop copies each new right-hand side into
    ``.b`` first.  With ``graph`` the blocks' captures outlive a solve,
    and a later solve that runs the same blocks replays them
    (``capture_first`` captures each at its first run; see
    ``solvers/graphs.py``).

    The loop is the BETA-FIRST rotation: p = r + βp opens the iteration
    and is followed at once by t = Ap and p'Ap, so ``coupled_step(r, p,
    beta) -> (p, t, p'Ap)`` can run them as one fused kernel pass.
    ``coupled_step=None`` derives the default from ``matvec``/``dot``.
    ``update(x, r, p, t, alpha) -> (rr, pp)`` moves x and r in place and
    returns the new |r|² (and |p|² when ``track_diff``, else None): one
    kernel pass (``acg_torch/ops/cg_update.py``); None runs ``addcmul_``
    twice and ``dot``.  ``guard`` tests |r|² and p'Ap for finiteness at
    the check points.  ``segment``, ``monitor_every``, ``graph``: see the
    module docstring."""
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
    S = _sys_shape(b)
    zero = _fill((), 0, dt, dev)
    one = _fill((), 1, dt, dev)
    nan = _fill((), float("nan"), dt, dev)

    def code(c):
        return torch.tensor(c, dtype=torch.int32, device=dev)

    ok, conv_c, brk, fault = (code(c) for c in
                              (_OK, _CONVERGED, _BREAKDOWN, _FAULT))
    x, r = torch.zeros_like(b), torch.zeros_like(b)
    hist = _fill(S + (maxits + 1,), float("nan"), dt, dev)
    hdim = hist.dim() - 1
    # the solve's thresholds, rewritten by every run: max(atol², rtol²
    # |r0|²), the diff threshold (per system for a batched diffrtol) and
    # whether a system has any criterion, under which an exactly-zero
    # residual is convergence (with none, fixed-iteration timing, the
    # loop runs on)
    thresh2, ds = _fill(S, 0, dt, dev), _fill(S, 0, dt, dev)
    crit = _fill(S, False, torch.bool, dev)
    # the carried state: x and r move in place; the rest is rebound by a
    # block and (graph) copied back into these buffers at its end
    c = types.SimpleNamespace(
        p=torch.zeros_like(b), rr=_fill(S, 0, dt, dev),
        beta=_fill(S, 0, dt, dev), dxx=_fill(S, float("inf"), dt, dev),
        flag=_fill(S, _OK, torch.int32, dev),
        kdev=_fill(S, 0, torch.int32, dev),
        kit=_fill((), 0, torch.int64, dev))
    bufs = _Buffers(c, ("p", "rr", "beta", "dxx", "flag"), graph)
    mon = _monitor(monitor_every, maxits, dt, dev)
    read = _reader(mon)
    runner = BlockRunner(dev, graph, capture_first=capture_first)

    def met(rr):
        return (rr < thresh2) | (crit & (rr == 0))

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

    def run(x0, stop2, diffstop, stats=None):
        runner.stats = stats
        bufs.reset()
        torch.sub(b, matvec(x0), out=r)
        rr0 = dot(r, r)
        atol2, rtol2 = stop2
        torch.maximum(atol2, rtol2 * rr0, out=thresh2)
        ds.copy_(torch.as_tensor(diffstop, dtype=dt, device=dev))
        crit.copy_((atol2 > 0) | (rtol2 > 0) | (ds > 0))
        _keep(x, x0)
        hist.fill_(float("nan"))
        hist[..., 0] = rr0
        _zero(c.p)
        c.rr.copy_(rr0)
        c.beta.zero_()
        c.dxx.fill_(float("inf"))
        c.flag.copy_(torch.where(met(rr0), conv_c, ok))
        c.kdev.zero_()
        c.kit.zero_()
        if mon is not None:
            mon.reset()
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
        # check_every > 1 the loop may pass the unobserved convergence
        # point
        flag = torch.where(met(c.rr), conv_c, c.flag)
        if batched:
            return x, c.kdev, c.rr, c.dxx, flag, rr0, hist
        return x, int(c.kdev), c.rr, c.dxx, int(flag), rr0, hist

    return types.SimpleNamespace(b=b, run=run, runner=runner)


def cg_pipelined_while(matvec, dot2, b, x0, stop2, maxits: int,
                       check_every: int = 1, replace_every: int = 0,
                       certify: bool = True, iter_step=None,
                       guard: bool = False, segment: int = 0,
                       monitor_every: int = 0, graph: bool = False,
                       stats=None):
    """Pipelined CG (Ghysels/Vanroose; ref acg/cgcuda.c:1676-1788) with
    ONE fused reduction point per iteration: ``dot2(a1, b1, a2, b2)``
    returns (a1·b1, a2·b2).  The port of
    ``acg_tpu.solvers.loops.cg_pipelined_while``: one solve on a loop of
    its own (:func:`cg_pipelined_loop`, then its ``run``).

    Returns ``(x, k, gamma, flag, gamma0, hist)``: ``k`` and ``flag``
    ints (flag 0 running, 1 converged, 3 non-finite caught by the guard),
    ``gamma``/``gamma0`` 0-d tensors (|r|² at exit and at x0), ``hist``
    the ``(maxits+1,)`` history of the recurred gamma, NaN past ``k``,
    holding the true residual at certification points.  A (B, n) ``b``
    runs the batched loop (:func:`_cg_pipelined_batched`): ``k`` and
    ``flag`` (B,) int32 tensors, ``gamma``/``gamma0`` (B,), ``hist``
    (B, maxits+1).  ``stop2`` is the (atol², rtol²) pair of 0-d tensors;
    the other arguments are :func:`cg_pipelined_loop`'s."""
    any_crit = bool(stop2[0] > 0) or bool(stop2[1] > 0)
    return cg_pipelined_loop(
        matvec, dot2, b, maxits, check_every=check_every,
        replace_every=replace_every, certify=certify, iter_step=iter_step,
        guard=guard, segment=segment, monitor_every=monitor_every,
        graph=graph, any_crit=any_crit).run(x0, stop2, stats)


def cg_pipelined_loop(matvec, dot2, b, maxits: int, check_every: int = 1,
                      replace_every: int = 0, certify: bool = True,
                      iter_step=None, guard: bool = False, segment: int = 0,
                      monitor_every: int = 0, graph: bool = False,
                      any_crit: bool = True, capture_first: bool = False):
    """The pipelined loop's state, as :func:`cg_loop` makes the classic
    one's: its ``run(x0, stop2, stats)`` runs one solve of
    :func:`cg_pipelined_while`, ``.b`` is its right-hand side buffer.
    ``any_crit`` (a criterion is enabled: an exactly-zero gamma then
    counts as met) is fixed with the loop; a caller that keeps the loop
    runs it only at tolerances of the same non-zero-ness.

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

    ``segment``, ``monitor_every``, ``graph``, ``capture_first``: as
    :func:`cg_loop`.  A (B, n) ``b`` makes the batched loop
    (:func:`_cg_pipelined_batched`), which takes the open-coded body
    only: ``iter_step`` is not batched."""
    if iter_step is not None and replace_every > 0:
        raise ValueError("iter_step requires replace_every == 0")
    if b.dim() == 2:
        if iter_step is not None:
            raise ValueError("iter_step (the single-kernel pipelined "
                             "iteration) is not batched; callers gate it "
                             "off for multi-RHS solves")
        return _cg_pipelined_batched(matvec, dot2, b, maxits, check_every,
                                     replace_every, certify, guard, segment,
                                     monitor_every, graph, any_crit,
                                     capture_first)
    dev, dt = b.device, b.dtype
    zero = _fill((), 0, dt, dev)
    one = _fill((), 1, dt, dev)
    nan = _fill((), float("nan"), dt, dev)
    fresh = _fill((), True, torch.bool, dev)
    cert_c = (fresh, ~fresh)               # certified: True, False
    thresh2 = _fill((), 0, dt, dev)

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

    def scalar(dtype=dt, v=0):
        return _fill((), v, dtype, dev)

    hist = _fill((maxits + 1,), float("nan"), dt, dev)
    # the carried state: the vectors move in their buffers (w between two
    # under iter_step); the scalars are rebound by a block and (graph)
    # copied back at its end.  a_i, bad_i, g_i: the coefficients and
    # gamma a step started from (a redo after certification needs them)
    c = types.SimpleNamespace(
        x=torch.zeros_like(b), p=torch.zeros_like(b), s=torch.zeros_like(b),
        z=torch.zeros_like(b), r=torch.zeros_like(b), w=torch.zeros_like(b),
        gamma=scalar(), delta=scalar(), alpha=scalar(), beta=scalar(),
        bad=scalar(torch.bool), a_i=scalar(), bad_i=scalar(torch.bool),
        g_i=scalar(), gn=scalar(), dn=scalar(), cand=scalar(torch.bool),
        kit=scalar(torch.int64))
    names = ("a_i", "bad_i", "g_i", "gn", "dn", "cand", "alpha", "beta",
             "bad", "gamma", "delta")
    wbuf = [c.w, torch.zeros_like(b)] if iter_step is not None else None
    if guard:
        # what the loop returns, frozen at the first non-finite pair
        c.alive = scalar(torch.bool)
        c.x_keep = torch.zeros_like(b)
        c.kdev = scalar(torch.int32)
        c.cert_t = scalar(torch.bool)
        names += ("cert_t", "alive")
    bufs = _Buffers(c, names, graph)
    mon = _monitor(monitor_every, maxits, dt, dev)
    read = _reader(mon)
    runner = BlockRunner(dev, graph, capture_first=capture_first)

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

    def run(x0, stop2, stats=None):
        runner.stats = stats
        bufs.reset()
        if wbuf:
            c.w = wbuf[0]
        torch.sub(b, matvec(x0), out=c.r)
        _keep(c.w, matvec(c.r))
        gamma0, delta0 = dot2(c.r, c.r, c.w, c.r)
        atol2, rtol2 = stop2
        torch.maximum(atol2, rtol2 * gamma0, out=thresh2)
        alpha0, beta0, bad0 = coefficients(gamma0, delta0, gamma0, zero,
                                           fresh)
        hist.fill_(float("nan"))
        hist[0] = gamma0
        _keep(c.x, x0)
        for v in (c.p, c.s, c.z):
            _zero(v)
        for name, v in (("gamma", gamma0), ("delta", delta0),
                        ("alpha", alpha0), ("beta", beta0), ("bad", bad0),
                        ("a_i", zero), ("bad_i", fresh), ("g_i", gamma0),
                        ("gn", gamma0), ("dn", delta0), ("cand", ~fresh)):
            getattr(c, name).copy_(v)
        c.kit.zero_()
        running = ~met(gamma0)
        if guard:
            c.alive.copy_(finite(gamma0, delta0))
            _keep(c.x_keep, c.x)
            c.kdev.zero_()
            c.cert_t.fill_(True)
            running = running & c.alive
        if mon is not None:
            mon.reset()
        k = 0
        parity = 0
        certified = True                   # gamma0 is a true residual
        running = maxits > 0 and bool(running)
        while running:
            n, check, rep = block_plan(k, maxits, check_every, segment,
                                       replace_every)
            cert = certify and check
            # with the guard, the step that waits on the certification
            # read ends after that read
            late = guard and cert

            def block(n=n, check=check, rep=rep, parity=parity, late=late):
                if wbuf:
                    c.w = wbuf[parity]
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
            # uncertified gamma below the threshold: certify that one
            # too (|b - A x|^2; JAX also forms w = A r, which gamma does
            # not use)
            need = ((met(gamma) & ~c.cert_t) if guard
                    else not certified and bool(met(gamma)))
            if bool(need):
                rt = b - matvec(x)
                gamma, _ = dot2(rt, rt, rt, rt)
            hist[k] = gamma
            flag = _CONVERGED if bool(met(gamma)) else _OK
        else:
            flag = _OK               # no criterion: nothing can be claimed
        if guard and not bool(finite(gamma, delta)):
            flag = _FAULT
        return x, k, gamma, flag, gamma0, hist

    return types.SimpleNamespace(b=b, run=run, runner=runner)


def _cg_pipelined_batched(matvec, dot2, b, maxits: int, check_every: int,
                          replace_every: int, certify: bool, guard: bool,
                          segment: int = 0, monitor_every: int = 0,
                          graph: bool = False, any_crit: bool = True,
                          capture_first: bool = False):
    """The pipelined loop for B systems against one operator (``b`` of
    shape (B, n)), the port of ``acg_tpu.solvers.loops``
    ``cg_pipelined_while`` in batched mode (``:669-922``) through the
    open-coded body; ``matvec`` and ``dot2`` act per system.  Its
    ``run(x0, stop2, stats)`` returns ``(x, ksys, gamma, flag, gamma0,
    hist)``: ``ksys`` and ``flag`` (B,) int32 tensors, ``gamma``/
    ``gamma0`` (B,), ``hist`` the (B, maxits+1) history, NaN past each
    system's exit.

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
    all are done.  Blocks as in :func:`cg_loop`; the step that waits on
    a certification read ends after it."""
    dev, dt = b.device, b.dtype
    S = _sys_shape(b)
    zero = _fill((), 0, dt, dev)
    one = _fill((), 1, dt, dev)
    nan = _fill((), float("nan"), dt, dev)
    thresh2 = _fill(S, 0, dt, dev)

    def met(g):
        m = g < thresh2
        return (m | (g == 0)) if any_crit else m

    def replace_state(x, p):
        """r, w, s, z recomputed from their definitions."""
        r = b - matvec(x)
        w = matvec(r)
        s = matvec(p)
        return r, w, s, matvec(s)

    def vec():
        return torch.zeros_like(b)

    def per_sys(dtype=dt):
        return _fill(S, 0, dtype, dev)

    hist = _fill(S + (maxits + 1,), float("nan"), dt, dev)
    c = types.SimpleNamespace(
        x=vec(), p=vec(), s=vec(), z=vec(), r=vec(), w=vec(),
        gamma=per_sys(), delta=per_sys(), gamma_prev=per_sys(),
        alpha_prev=per_sys(), fresh=per_sys(torch.bool),
        certified=per_sys(torch.bool), done=per_sys(torch.bool),
        ksys=per_sys(torch.int32), kit=_fill((), 0, torch.int64, dev),
        gn=per_sys(), dn=per_sys(), active=per_sys(torch.bool),
        cand=per_sys(torch.bool), alpha_i=per_sys(),
        bad_i=per_sys(torch.bool))
    names = ("gn", "dn", "active", "cand", "alpha_i", "bad_i", "gamma",
             "delta", "gamma_prev", "alpha_prev", "fresh", "certified",
             "done", "ksys")
    if guard:
        c.x_old = vec()
    bufs = _Buffers(c, names, graph)
    mon = _monitor(monitor_every, maxits, dt, dev)
    read = _reader(mon)
    runner = BlockRunner(dev, graph, capture_first=capture_first)

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

    def run(x0, stop2, stats=None):
        runner.stats = stats
        bufs.reset()
        torch.sub(b, matvec(x0), out=c.r)
        _keep(c.w, matvec(c.r))
        gamma0, delta0 = dot2(c.r, c.r, c.w, c.r)
        atol2, rtol2 = stop2
        torch.maximum(atol2, rtol2 * gamma0, out=thresh2)
        hist.fill_(float("nan"))
        hist[:, 0] = gamma0
        _keep(c.x, x0)
        for v in (c.p, c.s, c.z):
            _zero(v)
        for name, v in (("gamma", gamma0), ("delta", delta0),
                        ("gamma_prev", gamma0), ("gn", gamma0),
                        ("dn", delta0)):
            getattr(c, name).copy_(v)
        for v in (c.alpha_prev, c.alpha_i, c.ksys, c.active, c.cand):
            v.zero_()
        for v in (c.fresh, c.certified, c.bad_i):   # gamma0 is true
            v.fill_(True)
        # systems converged at x0 are done before the first iteration
        c.done.copy_(met(gamma0))
        c.kit.zero_()
        if mon is not None:
            mon.reset()
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

    return types.SimpleNamespace(b=b, run=run, runner=runner)


# ---------------------------------------------------------------------------
# s-step CG


def cg_sstep_while(block_fn, combine_fn, b, x0, p0, rr0, shifts0, stop2,
                   s: int, maxits: int, stats=None, monitor_every: int = 0,
                   graph: bool = False):
    """s-step (communication-reduced) CG, one Gram reduction per s
    iterations (arXiv:2501.03743; the port of
    ``acg_tpu.solvers.loops.cg_sstep_while``).

    A block is a fixed launch sequence on the device.  ``block_fn(x, p,
    shifts) -> (V, G)`` builds the (2s+1) basis: rows 0..s the
    Newton-shifted P block from p, rows s+1..2s the R block from the
    REPLACED residual r = b - A x (so G[s+1, s+1] is the true |b - A x|²
    every exit stands on), and its Gram matrix G = V Vᵀ.  The s inner
    steps run on the coefficients of their vectors in V (every inner
    product <u, v> with u = u'ᵀV, v = v'ᵀV is u'ᵀ G v', and A V is the
    Newton change-of-basis matrix): one launch of
    :func:`acg_torch.ops.sstep_coeffs.sstep_coeffs`, which also guards
    the block, writes the history, sets the next block's shifts (the
    Lanczos tridiagonal's Ritz values, Leja-ordered) and a status row a
    system.  Then every system's combinations ``combine_fn(c, V)``, both
    from one read of V: x += xcᵀV and p = pcᵀV, each GATED on a step having
    committed (a select, so 0 x inf never reaches x; the JAX loop's
    ``jnp.where(changed, ...)``).  The loop's state (x, p, the shifts,
    counts, flags, the last |r|² and the history) lives in buffers that
    a block updates in place, so ``graph=True`` (a CUDA device) replays
    one capture of the block (``solvers/graphs.py``) with the bits of
    ``graph=False``.  The host reads the status rows once a block, in
    one small copy: whether a system can go on, and with
    ``monitor_every`` the line the block boundary reports.

    Exit discipline, as in the JAX loop: convergence is decided only at
    block boundaries on the replaced residual; an inner estimate below
    tolerance pauses that system until the next block certifies it or
    resumes it; a true residual more than 1e4 x |r0|² above (the
    divergence guard), a non-finite Gram, an indefinite quadratic form
    beyond the coefficient-space roundoff floor, or a live block that
    committed nothing flags ``_GRAM_BAD`` with the block rolled back (x
    keeps its last good state), and the wrapper falls back to classic
    CG.  A complete block's shifts are kept when they are finite and
    positive.

    ``b``/``x0``/``p0`` are device tensors, (n,) or (B, n), or per-shard
    vectors (``acg_torch.parallel.sharded.ShardVec``, with ``V`` then a
    ``ShardStack`` and ``combine_fn`` applied shard by shard; the scalar
    state lives on the first shard's device); ``rr0`` and ``shifts0``
    host arrays ((B,) / (B, s), B = 1 for one system) in the vector
    dtype, ``stop2`` the host (atol², rtol²).  Returns ``(x, kiter, rr,
    flag, hist, shifts)`` with x on the device and the rest host arrays
    of leading axis B, ``hist`` (B, maxits+1) written at each system's
    own iteration cursor.  A ``SolveStats`` given as ``stats`` counts the
    blocks, the host seconds of the status reads (``tsstepwait``) and of
    the rest of each block on the host (``tsstephost``), and the
    runner's captures and replays."""
    batched = b.dim() == 2
    rr0 = np.asarray(rr0)
    vdt = rr0.dtype
    nsys = rr0.shape[0]
    m = 2 * s + 1
    dev = b.device
    atol2, rtol2 = stop2
    thresh2 = np.maximum(atol2, rtol2 * rr0).astype(vdt)
    any_crit = bool(atol2 > 0 or rtol2 > 0)

    def up(a):
        return torch.tensor(np.asarray(a, dtype=vdt), device=dev)

    # the loop's state, updated in place by every block
    c = types.SimpleNamespace(
        x=x0.clone(), p=p0.clone(), shifts=up(shifts0), rr=up(rr0),
        rr0=up(rr0), thresh2=up(thresh2),
        kiter=torch.zeros(nsys, dtype=torch.int64, device=dev),
        flag=torch.zeros(nsys, dtype=torch.int32, device=dev),
        hist=torch.full((nsys, maxits + 1), float("nan"), dtype=b.dtype,
                        device=dev),
        coef=torch.zeros((nsys, 2, m), dtype=b.dtype, device=dev),
        changed=torch.zeros(nsys, dtype=torch.bool, device=dev),
        status=torch.zeros((nsys, 3), dtype=torch.float64, device=dev))
    c.hist[:, 0] = c.rr0
    zero = torch.zeros((), dtype=b.dtype, device=dev)
    shifts = c.shifts if batched else c.shifts[0]

    def block():
        V, G = block_fn(c.x, c.p, shifts)
        sstep_coeffs(G.reshape(nsys, m, m), c.shifts, c.rr, c.rr0,
                     c.thresh2, c.kiter, c.flag, c.hist, c.coef, c.changed,
                     c.status, s, maxits, any_crit)
        for i in range(nsys):
            # system i of a batch through ``select``, which shard vectors
            # and basis stacks apply shard by shard
            xi, pi = ((c.x.select(0, i), c.p.select(0, i)) if batched
                      else (c.x, c.p))
            # both combinations from one read of the basis
            xp = combine_fn(c.coef[i], V.select(1, i) if batched else V)
            ch = c.changed[i]
            xi.add_(torch.where(ch, xp.select(0, 0), zero))
            torch.where(ch, xp.select(0, 1), pi, out=pi)

    runner = BlockRunner(dev, graph, stats)
    live = maxits > 0
    while live:
        t0 = time.perf_counter()
        runner.run("sstep", block)
        t_wait = time.perf_counter()
        live, kmon, mon = read_status(c.status)    # the block's one read
        t_host = time.perf_counter()
        if monitor_every > 0 and kmon % monitor_every == 0:
            emit_residual_line(kmon, mon)
        if stats is not None:
            stats.nsstepblocks += 1
            stats.tsstepwait += t_host - t_wait
            stats.tsstephost += (t_wait - t0) + (time.perf_counter() - t_host)
    host = [v.cpu().numpy() for v in (c.kiter, c.rr, c.flag, c.hist,
                                       c.shifts)]
    return (c.x, host[0], host[1], host[2].astype(np.int64), host[3],
            host[4])


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


def _zero(v) -> None:
    """A vector or a ring of them (a tensor, a ``ShardVec`` or a
    ``ShardStack``) to 0, in place."""
    for t in ((v,) if isinstance(v, torch.Tensor)
              else getattr(v, "shards", v)):
        t.zero_()


def deep_buffers(b, l: int, maxits: int, graph: bool = False, stats=None,
                 capture_first: bool = False):
    """The buffers one deep-pipelined solve's dispatches share: the rings
    of vectors (z: 2l+1, v: 2l), x and q, the fill chain's shifts
    (``shifts``, ([B,] l): a solve writes its own there and passes this
    tensor as the loop's ``shifts``), the scalar state of
    :func:`acg_torch.ops.deep_coeffs.deep_coeffs`, the pinned word of the
    one-body-late read and the solve's ``BlockRunner``, so every
    dispatch's blocks launch on the same addresses and one set of
    captures serves the whole solve (and, kept, later solves:
    ``capture_first`` as :class:`BlockRunner`).  ``b``: the right-hand
    side, (n,) or (B, n), or per-shard vectors."""
    w = 2 * l + 1
    dev, dt = b.device, b.dtype
    S = tuple((b if isinstance(b, torch.Tensor) else b[0]).shape[:-1])

    def full(shape, dtype=dt, v=0):
        return torch.full(shape, v, dtype=dtype, device=dev)

    return types.SimpleNamespace(
        Z=_window(b, w), Vr=_window(b, w - 1), x=b.clone(),
        q=torch.zeros_like(b), D=full((l,) + S + (w,)), G=full(S + (w, w)),
        gring=full((l,) + S), dring=full((l,) + S), sc=full(S + (5,)),
        flag=full(S, torch.int32), est=full(S, torch.bool),
        kdev=full((), torch.int32), kit=full((), torch.int64),
        ksys=full(S, torch.int32), hist=full(S + (maxits + 1,),
                                              v=float("nan")),
        co=full(S + (w + NCO,)), commit=full(S, torch.bool),
        act=full(S, torch.bool), live=full((), torch.bool),
        kmon=full((), torch.int32), shifts=full(S + (l,)),
        runner=BlockRunner(dev, graph, stats, capture_first),
        lag=(torch.empty((), dtype=torch.bool, pin_memory=True)
             if dev.type == "cuda" else None))


def cg_pipelined_deep_while(matvec, dots, combine_fn, dot, b, x0, stop2,
                            depth: int, shifts, maxits: int,
                            check_every: int = 1, replace_every: int = 0,
                            certify: bool = True, k_start: int = 0,
                            rr0_in=None, flags_in=None, hist_in=None,
                            ksys_in=None, guard: bool = False, fill=None,
                            cert_matvec=None, monitor=None,
                            graph: bool = False, buffers=None, stats=None):
    """Depth-l pipelined CG, l reductions in flight: ONE pipeline segment
    (dispatch) of the port of ``acg_tpu.solvers.loops``
    ``cg_pipelined_deep_while`` (p(l)-CG, Cornelis/Cools/Vanroose
    arXiv:1801.04728).

    The iteration runs on the shifted-Newton basis z_j = p_l(A) v_{j-l};
    each body issues ONE SpMV and ONE dot block ``dots(Z, z_new)`` (the
    2l+1 inner products of z_new with the window, a ([B,] 2l+1) result in
    the window's storage order) and consumes the block issued l bodies
    before: one launch of :func:`acg_torch.ops.deep_coeffs.deep_coeffs`
    finalizes column c = t+1 of the banded basis change G by forward
    substitution, reads (gamma_t, delta_t) off T G = G B, forms the
    D-Lanczos update's coefficients, whose residual estimate comes free,
    and updates the flags, counts and history on the device.  The body's
    vector work follows: ``combine_fn(c, V)`` forms sum_i c_i V_i (v_c's
    correction) in one product, then the x update, v_c, the new z and
    its dot block.  The window of z (2l+1 vectors), of v (the 2l the
    bodies read), the l pending dot blocks and the last l gammas and
    deltas are rings: a body writes over the oldest entry, so nothing is
    copied to slide a window, and each ring's head is a function of the
    body's index t in its dispatch.

    The host reads the flag only every ``check_every`` bodies (and at
    ``maxits`` or the ``replace_every`` bound), one body late on every
    device: the check point's live bit is handed to the host (on the
    card through a pinned copy and an event) and read after the next
    body was launched, so the copy overlaps it.  Between reads a system
    that breaks down or claims convergence FREEZES (every update is
    selected on its commit), so the host's body count equals the JAX
    count k while any system is live, and the extra bodies change
    nothing.  The bodies between two of the host's steps (a hand-over, a
    read, a bound) form a BLOCK whose launch sequence is fixed by its
    length, its check points and its first body's t (t itself while t <
    l, else its ring phase t mod (2l+1)2l): ``graph=True`` (a CUDA
    device) captures each distinct block once and replays it
    (``solvers/graphs.py``), with the bits of ``graph=False``.

    DISPATCH PROTOCOL (restart = residual replacement): the entry
    recomputes r = b - A x; the segment stops after ``replace_every``
    updates, on a claimed exit, or at ``maxits``; the certifier after the
    loop derives the TRUE residual and only a true value below the
    threshold flags ``_CONVERGED``; ``drift`` marks an estimate it
    refuted.  ``k_start`` (host int), ``rr0_in``, ``flags_in``,
    ``hist_in`` and ``ksys_in`` carry a solve across dispatches (None on
    the first), and ``buffers`` (:func:`deep_buffers`, made once for the
    solve; None for a lone dispatch) its vectors and block runner.  A
    non-positive LDL pivot or Cholesky diagonal freezes the system with
    ``_BREAKDOWN`` and no commit; ``guard`` flags a non-finite estimate
    or pivot ``_FAULT`` at the check points.

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

    ``shifts`` ([B,] l) is a device tensor.  ``stats`` (a ``SolveStats``)
    gets the runner's counts.  Returns ``(x, kret, rr, flag, rr0, hist,
    k, more, drift)``: ``rr`` the certified |r|² (or the last estimate
    without ``certify``), ``k`` the host update count to pass back as the
    next ``k_start``, ``more`` whether a system can go on; ``kret`` is
    ``k`` for one system, the per-system counts (B,) for a batch."""
    batched = b.dim() == 2
    l, w = depth, 2 * depth + 1
    if l < 2:
        raise ValueError("cg_pipelined_deep_while requires depth >= 2 "
                         "(depth 1 is cg_pipelined_while)")
    dev, dt = b.device, b.dtype
    bc = (lambda v: v[:, None]) if batched else (lambda v: v)
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    atol2, rtol2 = stop2
    k0 = int(k_start)
    cmv = matvec if cert_matvec is None else cert_matvec
    r = b - cmv(x0)
    eta2 = dot(r, r)
    c = (deep_buffers(b, l, maxits, graph, stats) if buffers is None
         else buffers)
    rr0 = eta2 if rr0_in is None else torch.where(rr0_in > 0, rr0_in, eta2)
    thresh2 = torch.maximum(atol2, rtol2 * rr0)
    any_crit = bool(atol2 > 0) or bool(rtol2 > 0)

    def met(g):
        m = g < thresh2
        return (m | (g == 0)) if any_crit else m

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

    Z, Vr = c.Z, c.Vr
    _zero(Z)
    torch.mul(r, bc(inv_eta), out=Z[l])
    fill([Z[l + j] for j in range(l + 1)])
    # the first l dot blocks: D_j = (z_{j+1-2l+a}, z_{j+1}), a = 0..2l
    c.D.zero_()
    for j in range(l):
        Dz = dots(Z, Z[l + j + 1])              # (z_i, z_{j+1}), i = -l..l
        c.D[j][..., l - j - 1:].copy_(Dz[..., : j + l + 2])
    # the v window, a ring of the 2l vectors the bodies read: v_0 = z_0
    _zero(Vr)
    Vr[w - 2].copy_(Z[l])
    c.G.zero_()
    c.G[..., w - 1, w - 1] = 1                   # g_{0,0} = 1
    c.gring.zero_()
    c.dring.zero_()
    if flags_in is None:
        c.flag.zero_()
    else:
        c.flag.copy_(flags_in)
    # the entry residual is true by construction: meeting the threshold
    # here is certified convergence
    c.flag.copy_(torch.where((c.flag == _OK) & met(eta2), _CONVERGED,
                             c.flag))
    c.est.zero_()
    if k0 == 0 or hist_in is None:
        c.hist.fill_(float("nan"))
        c.hist[..., 0] = rr0
    else:
        _keep(c.hist, hist_in)
    if batched:
        if ksys_in is None:
            c.ksys.zero_()
        else:
            c.ksys.copy_(ksys_in)
    c.kdev.fill_(k0)
    c.kit.fill_(k0)
    if monitor is not None:
        monitor.emitted = monitor.read_hi = k0
    _keep(c.x, x0)
    _zero(c.q)
    c.sc.copy_(torch.stack([eta, torch.zeros_like(eta), torch.zeros_like(eta),
                            eta2, thresh2.expand_as(eta)], dim=-1))
    rr_est = c.sc[..., 3]
    co = c.co
    lam, zdd, igcc, gam, dtm1, ic = (co[..., w - 1 + i] for i in range(6))

    def body(t: int, at_check: bool):
        hz, hv, hd = t % w, t % (w - 1), t % l
        deep_coeffs(c.D[hd], c.G, shifts, c.gring, c.dring, hd, c.sc,
                    c.flag, c.est, c.kdev, c.ksys, c.kit, c.hist, co,
                    c.commit, c.act, c.live, c.kmon, l, t, hv, at_check,
                    guard, any_crit)
        if monitor is not None:
            monitor.put(c.kmon, rr_est.amax() if batched else rr_est,
                        c.act.any() if batched else c.act)
        # sum_a g_{a,c} v_a over the v ring in order, for v_c below
        vsum = combine_fn(co[..., : w - 1], Vr)
        # the D-Lanczos x-update at t (its residual estimate is free)
        q_new = torch.addcmul(Vr[(hv + w - 2) % (w - 1)], bc(lam), c.q,
                              value=-1)
        x_new = torch.addcmul(c.x, bc(zdd), q_new)
        cm = bc(c.commit)
        torch.where(cm, x_new, c.x, out=c.x)
        torch.where(cm, q_new, c.q, out=c.q)
        # v_c = (z_c - sum_a g_{a,c} v_a) / g_{c,c} takes the v ring's
        # oldest slot, which nothing reads from here on
        torch.sub(Z[(hz + l + 1) % w], vsum, out=Vr[hv])
        Vr[hv].mul_(bc(igcc))
        # ONE SpMV and ONE dot block; the new z takes the oldest slot
        z_top, z_prev = Z[(hz + w - 1) % w], Z[(hz + w - 2) % w]
        wv = matvec(z_top)
        wv.addcmul_(bc(gam), z_top, value=-1)
        wv.addcmul_(bc(dtm1), z_prev, value=-1)
        torch.mul(wv, bc(ic), out=Z[hz])
        _keep(c.D[hd], torch.roll(dots(Z, Z[hz]), -((hz + 1) % w), dims=-1))

    def post():
        """Hand the live bit of the check point just run to the host."""
        if c.lag is None:
            return bool(c.live)
        c.lag.copy_(c.live, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        return ev

    def read(p):
        """The live bit that ``post`` handed over, on the host."""
        if c.lag is None:
            return p
        p.synchronize()
        return bool(c.lag)

    def bound(kk: int) -> bool:
        return kk >= maxits or (replace_every > 0 and kk - k0 >= replace_every)

    period = w * (w - 1)             # every ring's head repeats after it
    pending = None
    k = k0
    running = not bound(k) and bool(((c.flag == _OK) & ~c.est).any())
    while running:
        t0 = k - k0
        # the bodies up to the next hand-over, read or bound
        checks = []
        while True:
            checks.append((k + len(checks) + 1) % check_every == 0)
            if (bound(k + len(checks)) or checks[-1]
                    or (pending is not None and len(checks) == 1)):
                break
        checks = tuple(checks)

        def block(t0=t0, checks=checks):
            for i, at in enumerate(checks):
                body(t0 + i, at)

        c.runner.run((len(checks), t0 if t0 < l else l + t0 % period,
                      checks), block)
        k += len(checks)
        if bound(k):
            break
        if pending is not None:
            running, pending = read(pending), None
            if not running:
                break
        if checks[-1]:
            pending = post()
    # host and device counts agree while a system is live; the extra
    # bodies a frozen system ran between reads committed nothing
    k = int(c.kdev)
    flag = c.flag.clone()
    touched = flag == _OK
    hist = c.hist
    if certify:
        # TRUE-residual certification, once a dispatch: only a fresh
        # |b - A x|² below the threshold flags _CONVERGED
        rt = b - cmv(c.x)
        rr_true = dot(rt, rt)
        met_t = met(rr_true)
        flag = torch.where(touched & met_t, _CONVERGED, flag)
        drift = touched & c.est & ~met_t
        rr_ret = torch.where(touched, rr_true, rr_est)
        if batched:
            rows = torch.arange(c.ksys.shape[0], device=dev)
            kk = c.ksys.long()
            hist[rows, kk] = torch.where(touched, rr_true, hist[rows, kk])
        else:
            hist[k] = torch.where(touched, rr_true, hist[k])
    else:
        drift = torch.zeros_like(touched)
        rr_ret = rr_est.clone()
    more_sys = (flag == _OK) & (k < maxits)
    more = (bool(more_sys.any()) if monitor is None
            else monitor.read(more_sys.any(), k + 1))
    kret = c.ksys.clone() if batched else k
    return c.x, kret, rr_ret, flag, rr0, hist, k, more, drift
