"""One s-step block's coefficient work on the device, on the CPU.

``acg_torch/ops/sstep_coeffs.py`` moves the s-step block's coefficient
recurrences, Ritz step and Leja order from NumPy on the host into one
function of device tensors (a CUDA kernel on the card, its plain
PyTorch version here).  The parent's host loop is kept below
(``ref_cg_sstep_while`` with its NumPy block, ``ref_numpy_block``, as it
stood) and the plain version is held against it: one block on real Gram
matrices (flags, counts and ``changed`` equal; |r|² and the history
within 1e-12 (f64) / 1e-5 (f32) of max |G|, xc and pc within 1e-12 /
1e-3 of their scale; the shifts, whose
eigenvalues come from bisection instead of LAPACK, within 1e-10 / 1e-3),
and whole solves (counts within the existing tests' bands against
acg_tpu: f64 ±1, f32 ±(s + 2); x to 1e-9 at f64).  The loop's mechanics
(static buffers, the gated combinations, one status read a block) are
held BIT FOR BIT against the parent's host loop running the same plain
coefficient step (``ref_cg_sstep_while(block=plain_block)``), one
device and four shards.  The bisection is held against
``np.linalg.eigvalsh`` on random SPD tridiagonals (s = 2-8, within 16 s
eps |T|), and against ``acg_tpu``'s Leja order of LAPACK's eigenvalues.
"""

import importlib

import numpy as np
import pytest
import torch

from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.solvers import loops as jloops
from acg_tpu.solvers.cg import cg_sstep as jcg_sstep
from acg_tpu.sparse import poisson as jpoisson
from acg_torch.config import SolverOptions
from acg_torch.obs.monitor import emit_residual_line
from acg_torch.ops import sstep_coeffs as sc
from acg_torch.solvers.cg import (_cheb_leja_nodes, _sstep_block_fn,
                                  build_device_operator, cg_sstep)
from acg_torch.solvers.loops import _CONVERGED, _GRAM_BAD, _OK
from acg_torch.sparse import poisson as tpoisson

tcg = importlib.import_module("acg_torch.solvers.cg")
tcg_dist = importlib.import_module("acg_torch.solvers.cg_dist")


# ---------------------------------------------------------------------------
# the parent's host loop, as it stood (its NumPy block split out)


def ref_leja_order(v):
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


def ref_newton_basis_matrix(shifts, s):
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


def ref_numpy_block(G, shifts, rr, rr0, kiter, flag, hist, s, maxits,
                    thresh2, any_crit):
    """The parent's block on the host (loops.py:870-980 before the
    coefficient kernels): returns (shifts, rr, kiter, flag, xc, pc,
    changed, kmon, monval); ``hist`` in place."""
    vdt = rr0.dtype
    t = vdt.type
    nsys = rr0.shape[0]
    m = 2 * s + 1
    one, zero = t(1), t(0)

    def met(r):
        return (r < thresh2) | (any_crit & (r == 0))

    def hist_put(pos, mask, val):
        sel = np.nonzero(mask)[0]
        hist[sel, pos[sel]] = val[sel]

    e_p = np.zeros((nsys, m), vdt)
    e_p[:, 0] = 1
    e_r = np.zeros((nsys, m), vdt)
    e_r[:, s + 1] = 1
    eps = t(4.0 * m * np.finfo(vdt).eps)
    eye = np.eye(s, dtype=vdt)
    with np.errstate(all="ignore"):
        rr_true = G[:, s + 1, s + 1]
        gfin = np.all(np.isfinite(G), axis=(-2, -1))
        difn = gfin & ~met(rr_true) & (rr_true > t(1e4) * rr0)
        active0 = flag == _OK
        flag = np.where(active0 & (~gfin | difn), _GRAM_BAD,
                        np.where(active0 & met(rr_true), _CONVERGED, flag))
        hist_put(kiter, active0 & gfin, rr_true)
        kmon = int(np.max(kiter))
        monval = np.max(np.where(active0, rr_true, rr))
        active = flag == _OK
        Bmat = ref_newton_basis_matrix(shifts, s)
        kiter0 = kiter.copy()
        pc, rc = e_p.copy(), e_r.copy()
        xc = np.zeros_like(pc)
        rr_j = rr_true.copy()
        conv_est = np.zeros(nsys, bool)
        bad = np.zeros(nsys, bool)
        allok = active.copy()
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
        changed = kiter > kiter0
        stalled = active & ~changed & (kiter < maxits)
        flag = np.where(active & (bad | stalled), _GRAM_BAD, flag)
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
        valid = allok & np.all(np.isfinite(T), axis=(-2, -1))
        T = np.where(valid[:, None, None], T, eye)
        new_shifts = ref_leja_order(np.linalg.eigvalsh(T).astype(vdt))
        good = (valid & np.all(np.isfinite(new_shifts), axis=-1)
                & np.all(new_shifts > 0, axis=-1))
        shifts = np.where(good[:, None], new_shifts, shifts)
    return shifts, rr_j, kiter, flag, xc, pc, changed, kmon, monval


def plain_block(G, shifts, rr, rr0, kiter, flag, hist, s, maxits, thresh2,
                any_crit):
    """``ref_numpy_block``'s contract through the plain sstep_coeffs."""
    nsys = rr0.shape[0]
    m = 2 * s + 1
    st = dict(G=torch.from_numpy(np.ascontiguousarray(G)),
              shifts=torch.from_numpy(shifts.copy()),
              rr=torch.from_numpy(np.asarray(rr).copy()),
              rr0=torch.from_numpy(rr0.copy()),
              thresh2=torch.from_numpy(np.asarray(thresh2, rr0.dtype)
                                       .reshape(nsys).copy()),
              kiter=torch.from_numpy(kiter.astype(np.int64)),
              flag=torch.from_numpy(flag.astype(np.int32)),
              hist=torch.from_numpy(hist.copy()),
              coef=torch.zeros((nsys, 2, m), dtype=torch.from_numpy(G).dtype),
              changed=torch.zeros(nsys, dtype=torch.bool),
              status=torch.zeros((nsys, 3), dtype=torch.float64))
    sc.sstep_coeffs_plain(**st, s=s, maxits=maxits, any_crit=any_crit)
    hist[...] = st["hist"].numpy()
    return (st["shifts"].numpy(), st["rr"].numpy(), st["kiter"].numpy(),
            st["flag"].numpy().astype(np.int64), st["coef"][:, 0].numpy(),
            st["coef"][:, 1].numpy(), st["changed"].numpy(),
            *sc.read_status(st["status"])[1:])


def ref_cg_sstep_while(block_fn, combine_fn, b, x0, p0, rr0, shifts0, stop2,
                       s, maxits, stats=None, monitor_every=0, graph=False,
                       block=ref_numpy_block):
    """The parent's host loop (loops.py:794-985 before the coefficient
    kernels): G copied down once a block, ``block`` on the host, the moved
    systems' combinations launched one by one."""
    batched = b.dim() == 2
    vdt = rr0.dtype
    nsys = rr0.shape[0]
    m = 2 * s + 1
    atol2, rtol2 = stop2
    thresh2 = np.maximum(atol2, rtol2 * rr0)
    any_crit = bool(atol2 > 0 or rtol2 > 0)
    x, p = x0.clone(), p0
    rr, shifts = rr0.copy(), shifts0.copy()
    kiter = np.zeros(nsys, np.int64)
    flag = np.zeros(nsys, np.int64)
    hist = np.full((nsys, maxits + 1), np.nan, dtype=vdt)
    hist[:, 0] = rr0
    while np.any((flag == _OK) & (kiter < maxits)):
        V, G = block_fn(x, p, shifts if batched else shifts[0])
        G = G.cpu().numpy().reshape(nsys, m, m)
        (shifts, rr, kiter, flag, xc, pc, changed, kmon,
         monval) = block(G, shifts, rr, rr0, kiter, flag, hist, s, maxits,
                         thresh2, any_crit)
        if monitor_every > 0 and kmon % monitor_every == 0:
            emit_residual_line(kmon, monval)
        moved = np.nonzero(changed)[0]
        if moved.size:
            cdev = torch.from_numpy(np.stack([xc[moved], pc[moved]],
                                             axis=1)).to(x.device)
        for j, i in enumerate(moved):
            xi, pi = ((x.select(0, i), p.select(0, i)) if batched
                      else (x, p))
            xp = combine_fn(cdev[j], V.select(1, i) if batched else V)
            xi.add_(xp.select(0, 0))
            pi.copy_(xp.select(0, 1))
        if stats is not None:
            stats.nsstepblocks += 1
    return x, kiter, rr, flag, hist, shifts


# ---------------------------------------------------------------------------
# one block


def _grams(s, nsys, dtype, seed):
    A = tpoisson.poisson3d_7pt(8)
    op = build_device_operator(A, dtype=dtype, device="cpu")
    rng = np.random.default_rng(seed)
    th = (12.0 * _cheb_leja_nodes(s)).astype(dtype)
    out = []
    for i in range(nsys):
        b = np.zeros(op.nrows_padded, dtype)
        b[: A.nrows] = rng.standard_normal(A.nrows)
        x = np.zeros_like(b)
        x[: A.nrows] = 0.1 * i * rng.standard_normal(A.nrows)
        bt = torch.from_numpy(b)
        r = bt - op.matvec(torch.from_numpy(x))
        _, G = _sstep_block_fn(op.matvec, bt, s)(torch.from_numpy(x), r, th)
        out.append(G.numpy())
    return np.stack(out), np.tile(th, (nsys, 1))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("s,nsys", [(2, 1), (3, 3), (4, 2), (6, 1)])
def test_plain_block_matches_the_numpy_recurrence(s, nsys, dtype):
    G, th = _grams(s, nsys, dtype, seed=s)
    rr0 = G[:, s + 1, s + 1].copy()
    maxits = 30
    flag = np.zeros(nsys, np.int64)
    kiter = np.zeros(nsys, np.int64)
    if nsys > 2:
        flag[1] = _CONVERGED                 # a finished system stays put
        kiter[2] = maxits - 1                # one step left
    out = {}
    for name, fn in (("ref", ref_numpy_block), ("plain", plain_block)):
        hist = np.full((nsys, maxits + 1), np.nan, dtype)
        res = fn(G.copy(), th.copy(), rr0.copy(), rr0, kiter.copy(),
                 flag.copy(), hist, s, maxits,
                 np.maximum(dtype(0), dtype(1e-20) * rr0), True)
        out[name] = res + (hist,)
    ref, got = out["ref"], out["plain"]
    for i in (2, 3, 6):                      # kiter, flag, changed
        np.testing.assert_array_equal(got[i], ref[i])
    assert got[7] == ref[7]
    assert np.any(ref[6])
    # the sums run in another order than NumPy's: the quadratic forms
    # c'Gc carry m eps |G| |c|^2 of cancellation (the recurrence's own
    # floor), which at f32 is a visible share of a small |r|^2
    tol = 1e-12 if dtype == np.float64 else 1e-5
    gmax = np.abs(G).max()
    for i in (1, 9):                         # rr, hist: against |G|
        np.testing.assert_allclose(got[i], ref[i], rtol=0, atol=tol * gmax)
    ctol = 1e-12 if dtype == np.float64 else 1e-3
    for i in (4, 5):                         # xc, pc
        scale = np.abs(ref[i]).max()
        np.testing.assert_allclose(got[i], ref[i], rtol=0,
                                   atol=ctol * scale)
    # the shifts: bisection against LAPACK, on alphas and betas that
    # carry the differences above
    stol = 1e-10 if dtype == np.float64 else 1e-3
    np.testing.assert_allclose(got[0], ref[0], rtol=stol)
    assert abs(got[8] - ref[8]) <= tol * gmax


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("s", [2, 3, 4, 5, 6, 7, 8])
def test_bisection_matches_eigvalsh(s, dtype):
    """Random SPD tridiagonals (diagonal 1-10, off-diagonals up to 1):
    every eigenvalue within 16 s eps |T|_inf of LAPACK's."""
    rng = np.random.default_rng(100 + s)
    B = 6
    d = (1.0 + 9.0 * rng.random((B, s))).astype(dtype)
    e = (rng.random((B, s - 1)) - 0.5).astype(dtype)
    T = np.zeros((B, s, s), dtype)
    idx = np.arange(s)
    T[:, idx, idx] = d
    T[:, idx[:-1], idx[:-1] + 1] = e
    T[:, idx[:-1] + 1, idx[:-1]] = e
    want = np.linalg.eigvalsh(T.astype(np.float64))
    got = sc.tridiag_eigvalsh(torch.from_numpy(d), torch.from_numpy(e))
    assert got.dtype == torch.from_numpy(d).dtype
    norm = np.abs(T).sum(axis=-1).max(axis=-1, keepdims=True)
    tol = 16 * s * np.finfo(dtype).eps * norm
    assert np.all(np.abs(got.numpy() - want) <= tol)
    assert np.all(np.diff(got.numpy(), axis=-1) >= 0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_bisection_degenerate_spectra(dtype):
    """Equal eigenvalues, zero off-diagonals (the diagonal, sorted) and
    the identity an invalid block uses: exact; the identity's Leja order
    is its own."""
    s = 5
    d = torch.tensor([[3.0] * s, [4.0, 1.0, 5.0, 2.0, 3.0], [1.0] * s],
                     dtype=torch.from_numpy(np.zeros(1, dtype)).dtype)
    e = torch.zeros((3, s - 1), dtype=d.dtype)
    got = sc.tridiag_eigvalsh(d, e)
    want = torch.sort(d, dim=1).values
    tol = 4 * np.finfo(dtype).eps * 5
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(sc.leja_order(torch.ones((2, s), dtype=d.dtype)),
                       torch.ones((2, s), dtype=d.dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("s", [2, 4, 6])
def test_shifts_are_acg_tpus_leja_of_eigvalsh(s, dtype):
    """leja_order ∘ tridiag_eigvalsh against acg_tpu's _leja_order of
    LAPACK's eigenvalues, on Lanczos-like tridiagonals: the same order,
    the values within 1e-10 (f64) / 1e-4 (f32)."""
    rng = np.random.default_rng(7 * s)
    B = 4
    d = (0.5 + 12.0 * rng.random((B, s))).astype(dtype)
    e = (0.5 * rng.random((B, s - 1))).astype(dtype)
    T = np.zeros((B, s, s), dtype)
    idx = np.arange(s)
    T[:, idx, idx] = d
    T[:, idx[:-1], idx[:-1] + 1] = e
    T[:, idx[:-1] + 1, idx[:-1]] = e
    want = np.asarray(jloops._leja_order(np.linalg.eigvalsh(T)))
    got = sc.leja_order(sc.tridiag_eigvalsh(torch.from_numpy(d),
                                            torch.from_numpy(e))).numpy()
    np.testing.assert_allclose(got, want,
                               rtol=1e-10 if dtype == np.float64 else 1e-4)


# ---------------------------------------------------------------------------
# whole solves


def _pair(make, seed, nrhs=0):
    Aj, At = make(jpoisson), make(tpoisson)
    b = np.random.default_rng(seed).standard_normal(At.nrows)
    if nrhs:
        b = np.stack([b * (1.0 + 0.5 * i) + 0.1 * i for i in range(nrhs)])
    return Aj, At, b


def _with_loop(monkeypatch, module, block):
    def ref(*a, **k):
        return ref_cg_sstep_while(*a, block=block, **k)
    monkeypatch.setattr(module, "cg_sstep_while", ref)


def _same(r1, r2):
    assert r1.niterations == r2.niterations
    np.testing.assert_array_equal(r1.x, r2.x)
    np.testing.assert_array_equal(r1.residual_history, r2.residual_history)
    assert (r1.converged, r1.kernel_note) == (r2.converged, r2.kernel_note)
    if r1.iterations_per_system is not None:
        np.testing.assert_array_equal(r1.iterations_per_system,
                                      r2.iterations_per_system)


@pytest.mark.parametrize("nrhs", [0, 3])
@pytest.mark.parametrize("s", [2, 3, 4])
def test_block_loop_bits_against_the_parent_loop(monkeypatch, s, nrhs):
    """The device loop (open, on the CPU) against the parent's host loop
    running the same plain coefficient step: bit for bit."""
    _, At, b = _pair(lambda m: m.poisson3d_7pt(7), s, nrhs)
    o = SolverOptions(maxits=500, residual_rtol=1e-10, sstep=s,
                      monitor_every=0)
    got = cg_sstep(At, b, options=o, device="cpu", loop="open")
    with monkeypatch.context() as mp:
        _with_loop(mp, tcg, plain_block)
        want = cg_sstep(At, b, options=o, device="cpu")
    _same(got, want)
    assert got.loop == "open" and got.stats.nsstepblocks >= 1


@pytest.mark.parametrize("nrhs", [0, 3])
@pytest.mark.parametrize("s", [2, 3, 4])
def test_sstep_against_the_numpy_loop_and_acg_tpu(monkeypatch, s, nrhs):
    """The device loop against the parent's NumPy loop and acg_tpu at
    f64: counts within 1, x within 1e-9 of each."""
    Aj, At, b = _pair(lambda m: m.poisson3d_7pt(7), 10 + s, nrhs)
    o = dict(maxits=500, residual_rtol=1e-10, sstep=s)
    got = cg_sstep(At, b, options=SolverOptions(**o), device="cpu")
    with monkeypatch.context() as mp:
        _with_loop(mp, tcg, ref_numpy_block)
        par = cg_sstep(At, b, options=SolverOptions(**o), device="cpu")
    jax = jcg_sstep(Aj, b, options=JOptions(**o))
    for want in (par, jax):
        k1 = np.atleast_1d(got.iterations_per_system if nrhs
                           else got.niterations)
        k2 = np.atleast_1d(want.iterations_per_system if nrhs
                           else want.niterations)
        assert np.all(np.abs(k1 - k2) <= 1)
        assert (np.linalg.norm(got.x - want.x)
                <= 1e-9 * np.linalg.norm(want.x))
    assert got.converged


@pytest.mark.parametrize("s", [2, 4])
def test_sstep_f32_against_acg_tpu(s):
    """f32: counts within s + 2 of acg_tpu's, both certified within 5 x
    rtol (the existing tests' band)."""
    rtol = 1e-5
    Aj, At, b = _pair(lambda m: m.poisson2d_5pt(16), 21)
    o = dict(maxits=4000, residual_rtol=rtol, sstep=s)
    rj = jcg_sstep(Aj, b, dtype=np.float32, options=JOptions(**o))
    rt = cg_sstep(At, b, dtype=np.float32, options=SolverOptions(**o),
                  device="cpu")
    assert rt.converged and rj.converged
    assert abs(rt.niterations - rj.niterations) <= s + 2
    r = b - At.matvec(rt.x.astype(np.float64))
    assert np.linalg.norm(r) <= 5 * rtol * np.linalg.norm(b)


def test_sstep_dist_bits_against_the_parent_loop(monkeypatch):
    """Four CPU shards: the device loop against the parent's host loop
    with the same coefficient step, bit for bit; against acg_tpu's
    distributed s-step, counts within 1."""
    from acg_tpu.solvers.cg_dist import cg_sstep_dist as jcg_sstep_dist

    Aj, At, b = _pair(lambda m: m.poisson3d_7pt(8), 5)
    o = dict(maxits=500, residual_rtol=1e-10, sstep=3)
    kw = dict(nparts=4, devices=["cpu"] * 4)
    got = tcg_dist.cg_sstep_dist(At, b, options=SolverOptions(**o), **kw)
    with monkeypatch.context() as mp:
        _with_loop(mp, tcg_dist, plain_block)
        want = tcg_dist.cg_sstep_dist(At, b, options=SolverOptions(**o),
                                      **kw)
    _same(got, want)
    part = tcg_dist.partition_graph(At, 4)
    jr = jcg_sstep_dist(Aj, b, options=JOptions(**o), part=part)
    assert abs(got.niterations - jr.niterations) <= 1


def test_status_word_and_monitor_lines(monkeypatch):
    """monitor_every: the lines the parent's loop emitted at its block
    boundaries come from the status rows, the same (k, value) pairs."""
    from acg_torch.obs import monitor

    _, At, b = _pair(lambda m: m.poisson3d_7pt(7), 8)
    o = SolverOptions(maxits=500, residual_rtol=1e-10, sstep=3,
                      monitor_every=3)
    lines = {}
    for name in ("new", "parent"):
        got = []

        def sink(k, rr, got=got):
            got.append((int(k), float(rr)))

        monitor.add_monitor_sink(sink)
        try:
            with monitor.muted(), monkeypatch.context() as mp:
                if name == "parent":
                    _with_loop(mp, tcg, plain_block)
                cg_sstep(At, b, options=o, device="cpu")
        finally:
            monitor.remove_monitor_sink(sink)
        lines[name] = got
    assert lines["new"] == lines["parent"] and len(lines["new"]) >= 2
    assert all(k % 3 == 0 for k, _ in lines["new"])


def test_sstep_coeffs_refuses_bad_operands_off_cpu():
    """The wrapper's checks: a non-CPU, non-CUDA device raises; shapes
    are checked only on CUDA (the plain version takes what it is
    given)."""
    from acg_torch.errors import AcgError, Status

    meta = torch.zeros((1, 5, 5), device="meta")
    with pytest.raises(AcgError) as ei:
        sc.sstep_coeffs(meta, *([None] * 10), s=2, maxits=4, any_crit=True)
    assert ei.value.status == Status.ERR_NOT_SUPPORTED
    assert sc.smem_bytes(16, torch.float64) <= sc.SMEM_LIMIT
    assert sc.smem_bytes(40, torch.float64) > sc.SMEM_LIMIT
