"""One depth-l pipelined body's scalar chain on the device, on the CPU.

``acg_torch/ops/deep_coeffs.py`` moves the deep pipeline's scalar chain
(forward substitution, gamma/delta, the D-Lanczos coefficients, flags,
counts, the history) from about a hundred host-launched torch
operations into one function of device buffers (a CUDA kernel on the
card, its plain PyTorch version here), and the loop
(``cg_pipelined_deep_while``) onto static buffers and device rings with
host phases.  The parent's dispatch is kept below
(``ref_cg_pipelined_deep_while``, as it stood), and its body's chain
(``ref_chain``): the plain version is held BIT FOR BIT against that
chain (l = 2 and 3, B = 1 and 3, t < l, the recurrence, a breakdown),
and whole solves bit for bit against the parent's dispatch (one device
with check_every 1 and 3 and replace_every 0 and 50, batches, the
guard, four shards) and against ``acg_tpu`` within the existing tests'
tolerances (f64 counts within 1, x within 1e-9).  The card's side
(kernel = plain bit for bit, graph = open) is in
``tests/test_torch_cuda.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.solvers.cg import cg_pipelined_deep as jdeep
from acg_tpu.sparse import poisson as jpoisson
from acg_torch.config import SolverOptions
from acg_torch.ops import deep_coeffs as dc
from acg_torch.solvers.cg import cg_pipelined_deep
from acg_torch.solvers.loops import (_BREAKDOWN, _CONVERGED, _FAULT, _OK,
                                     _window)
from acg_torch.sparse import poisson as tpoisson

tcg = importlib.import_module("acg_torch.solvers.cg")
tcg_dist = importlib.import_module("acg_torch.solvers.cg_dist")


# ---------------------------------------------------------------------------
# the parent's dispatch, as it stood

def ref_cg_pipelined_deep_while(matvec, dots, combine_fn, dot, b, x0, stop2,
                            depth: int, shifts, maxits: int,
                            check_every: int = 1, replace_every: int = 0,
                            certify: bool = True, k_start: int = 0,
                            rr0_in=None, flags_in=None, hist_in=None,
                            ksys_in=None, guard: bool = False, fill=None,
                            cert_matvec=None, monitor=None, graph=False,
                            buffers=None, stats=None):
    """The parent's deep dispatch (loops.py:1002-1326 before the
    coefficient kernels)."""
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


def ref_chain(st, D, t, l, hv, at_check, guard, any_crit, k):
    """The parent body's scalar chain (loops.py:1197-1290 before the
    coefficient kernels) on a state of lists and 0-d / (B,) tensors;
    returns the coefficients the body's vector operations read."""
    batched = st["flag"].dim() == 1
    w = 2 * l + 1
    G = st["G"]
    dt, dev = G.dtype, G.device
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    flag, est = st["flag"], st["est"]
    thresh2 = st["thresh2"]

    def met(g):
        m = g < thresh2
        return (m | (g == 0)) if any_crit else m

    brk_c = torch.tensor(_BREAKDOWN, dtype=torch.int32)
    fault_c = torch.tensor(_FAULT, dtype=torch.int32)
    active = (flag == _OK) & ~est
    Gr = torch.zeros_like(G)
    Gr[..., : w - 1, : w - 1] = G[..., 1:, 1:]
    col = []
    for a in range(w - 1):
        acc = D[..., a]
        for kk in range(a):
            acc = acc - col[kk] * Gr[..., kk, a]
        gaa = Gr[..., a, a]
        ok = gaa != 0
        col.append(torch.where(ok, acc / torch.where(ok, gaa, one), zero))
    gcc2 = D[..., w - 1]
    for kk in range(w - 1):
        gcc2 = gcc2 - col[kk] * col[kk]
    good_g = gcc2 > 0
    gcc = torch.sqrt(torch.clamp(gcc2, min=0))
    colv = torch.stack(col, dim=-1)
    Gr[..., : w - 1, w - 1] = colv
    Gr[..., w - 1, w - 1] = gcc
    G = Gr
    gbuf, dlbuf, shifts = st["gbuf"], st["dlbuf"], st["shifts"]
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
    d_prev, zeta_prev = st["d_prev"], st["zeta_prev"]
    if t == 0:
        lam, zeta = torch.zeros_like(d_prev), st["eta"]
    else:
        lam = d_tm1 / torch.where(d_prev != 0, d_prev, one)
        zeta = -lam * zeta_prev
    dd = gam_t - d_tm1 * lam
    dd_s = torch.where(dd != 0, dd, one)
    rr_new = (del_t * zeta / dd_s) ** 2
    bad = (dd <= 0) | ~good_g
    commit = active & ~bad
    st["d_prev"] = torch.where(commit, dd, d_prev)
    st["zeta_prev"] = torch.where(commit, zeta, zeta_prev)
    st["rr_est"] = torch.where(commit, rr_new, st["rr_est"])
    flag = torch.where(active & bad, brk_c, flag)
    if guard and at_check:
        nonfin = ~(torch.isfinite(rr_new) & torch.isfinite(gcc2))
        flag = torch.where(active & nonfin, fault_c, flag)
    if at_check:
        est = est | (commit & met(rr_new))
    st["kmon"] = st["kdev"] + 1
    st["kdev"] = st["kdev"] + (commit.any() if batched else commit)
    hist = st["hist"]
    if batched:
        hist[:, k + 1] = torch.where(commit, rr_new, nan)
        st["ksys"] = torch.where(commit, k + 1, st["ksys"])
    else:
        hist[k + 1] = torch.where(commit, rr_new, hist[k + 1])
    c_s = torch.where(del_t != 0, del_t, one)
    st["gbuf"] = gbuf[1:] + [gam_t]
    st["dlbuf"] = dlbuf[1:] + [del_t]
    st.update(G=G, flag=flag, est=est)
    return dict(col=torch.roll(colv, hv, dims=-1), lam=lam,
                zdd=zeta / dd_s, igcc=one / gcc_s, gam=gam_t, dtm1=d_tm1,
                ic=one / c_s, commit=commit, act=active,
                live=((flag == _OK) & ~est).any())


# ---------------------------------------------------------------------------
# the chain


def _random_state(l, nsys, dtype, maxits, seed):
    rng = np.random.default_rng(seed)
    w = 2 * l + 1
    S = (nsys,) if nsys > 1 else ()
    tdt = torch.float64 if dtype == np.float64 else torch.float32

    def t(a):
        return torch.tensor(np.asarray(a), dtype=tdt)

    G = np.triu(rng.standard_normal(S + (w, w)) * 0.1)
    idx = np.arange(w)
    G[..., idx, idx] = 1.0 + rng.random(S + (w,))
    sc = np.stack([1.0 + rng.random(S), 1.0 + rng.random(S),
                   rng.standard_normal(S), rng.random(S),
                   np.full(S, 1e-30)], axis=-1)
    gring = 1.0 + rng.random((l,) + S)
    dring = 0.5 + rng.random((l,) + S)
    return S, dict(
        G=t(G), shifts=t(2.0 + rng.random(S + (l,))), gring=t(gring),
        dring=t(dring), sc=t(sc), flag=torch.zeros(S, dtype=torch.int32),
        est=torch.zeros(S, dtype=torch.bool),
        kdev=torch.tensor(3, dtype=torch.int32),
        ksys=torch.zeros(S, dtype=torch.int32),
        kit=torch.tensor(3, dtype=torch.int64),
        hist=torch.full(S + (maxits + 1,), float("nan"), dtype=tdt),
        co=torch.zeros(S + (w + dc.NCO,), dtype=tdt),
        commit=torch.zeros(S, dtype=torch.bool),
        act=torch.zeros(S, dtype=torch.bool),
        live=torch.zeros((), dtype=torch.bool),
        kmon=torch.zeros((), dtype=torch.int32)), rng


def _bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.is_floating_point():
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nsys", [1, 3])
@pytest.mark.parametrize("l", [2, 3])
def test_plain_chain_is_the_parent_chain(l, nsys, dtype):
    """Twelve bodies from one random state, the dot block new each body
    (a negative diagonal in body 10: a breakdown), check points every
    third body, the guard on: deep_coeffs_plain's buffers and
    coefficients bit-equal to the parent's chain after every body."""
    maxits = 40
    S, new, rng = _random_state(l, nsys, dtype, maxits, seed=l * 10 + nsys)
    w = 2 * l + 1
    sc = new["sc"]
    ref = dict(G=new["G"].clone(), shifts=new["shifts"],
               gbuf=[v.clone() for v in new["gring"]],
               dlbuf=[v.clone() for v in new["dring"]],
               eta=sc[..., 0].clone(), d_prev=sc[..., 1].clone(),
               zeta_prev=sc[..., 2].clone(), rr_est=sc[..., 3].clone(),
               thresh2=sc[..., 4].clone(), flag=new["flag"].clone(),
               est=new["est"].clone(), kdev=new["kdev"].clone(),
               ksys=new["ksys"].clone(), hist=new["hist"].clone())
    k = int(new["kit"])
    for t in range(12):
        D = rng.standard_normal(S + (w,)) * 0.1
        D[..., w - 1] = -1.0 if t == 10 else 4.0 + rng.random(S)
        D = torch.tensor(D, dtype=new["G"].dtype)
        kw = dict(l=l, t=t, hv=t % (w - 1), at_check=t % 3 == 2,
                  guard=True, any_crit=True)
        want = ref_chain(ref, D, k=k, **kw)
        dc.deep_coeffs_plain(D, hh=t % l, **new, **kw)
        k += 1
        co = new["co"]
        got = dict(col=co[..., : w - 1], lam=co[..., w - 1],
                   zdd=co[..., w], igcc=co[..., w + 1], gam=co[..., w + 2],
                   dtm1=co[..., w + 3], ic=co[..., w + 4],
                   commit=new["commit"], act=new["act"], live=new["live"])
        for name in want:
            _bits(got[name].contiguous(), want[name].reshape(
                got[name].shape).contiguous())
        _bits(new["G"], ref["G"])
        for i, name in enumerate(("eta", "d_prev", "zeta_prev", "rr_est")):
            _bits(new["sc"][..., i].contiguous(), ref[name])
        for name in ("flag", "est", "hist", "kdev", "kmon"):
            _bits(new[name], ref[name].to(new[name].dtype))
        if nsys > 1:
            _bits(new["ksys"], ref["ksys"].to(torch.int32))
        assert int(new["kit"]) == k
        # the rings: the parent's lists, oldest first, from head t+1
        for ring, lst in (("gring", "gbuf"), ("dring", "dlbuf")):
            for j in range(l):
                _bits(new[ring][(t + 1 + j) % l], ref[lst][j])
    assert bool((new["flag"] == _BREAKDOWN).any())


def test_chain_refuses_other_devices():
    from acg_torch.errors import AcgError, Status

    G = torch.zeros((5, 5), device="meta")
    with pytest.raises(AcgError) as ei:
        dc.deep_coeffs(None, G, *([None] * 16), l=2, t=0, hv=0,
                       at_check=True, guard=False, any_crit=True)
    assert ei.value.status == Status.ERR_NOT_SUPPORTED


# ---------------------------------------------------------------------------
# whole solves


def _pair(make, seed, nrhs=0):
    Aj, At = make(jpoisson), make(tpoisson)
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(At.nrows)
    if nrhs:
        b = np.stack([b * (1.0 + 0.5 * i) + 0.1 * i for i in range(nrhs)])
    return Aj, At, b


def _same(r1, r2):
    assert r1.niterations == r2.niterations
    np.testing.assert_array_equal(r1.x, r2.x)
    np.testing.assert_array_equal(r1.residual_history, r2.residual_history)
    assert (r1.converged, r1.status, r1.kernel_note) == (
        r2.converged, r2.status, r2.kernel_note)
    if r1.iterations_per_system is not None:
        np.testing.assert_array_equal(r1.iterations_per_system,
                                      r2.iterations_per_system)


def _solve(fn, *a, **k):
    from acg_torch.errors import AcgError

    try:
        return fn(*a, **k)
    except AcgError as e:
        if e.result is None:
            raise
        return e.result


@pytest.mark.parametrize("nrhs", [0, 3])
@pytest.mark.parametrize("replace_every", [0, 50])
@pytest.mark.parametrize("check_every", [1, 3])
def test_deep_loop_bits_against_the_parent_loop(monkeypatch, check_every,
                                                replace_every, nrhs):
    """The static-buffer loop (open, on the CPU) against the parent's
    dispatch: x, the counts, the history, the flags, the dispatches (the
    note), bit for bit, l = 2; and against acg_tpu at f64 (counts within
    1, x within 1e-9)."""
    Aj, At, b = _pair(lambda m: m.poisson3d_7pt(8), 3 + check_every, nrhs)
    o = dict(maxits=600, residual_rtol=1e-10, pipeline_depth=2,
             check_every=check_every, replace_every=replace_every)
    got = _solve(cg_pipelined_deep, At, b, options=SolverOptions(**o),
                 device="cpu", loop="open")
    with monkeypatch.context() as mp:
        mp.setattr(tcg, "cg_pipelined_deep_while",
                   ref_cg_pipelined_deep_while)
        want = _solve(cg_pipelined_deep, At, b, options=SolverOptions(**o),
                      device="cpu")
    _same(got, want)
    assert got.converged
    jr = jdeep(Aj, b, options=JOptions(**o))
    k1 = np.atleast_1d(got.iterations_per_system if nrhs
                       else got.niterations)
    k2 = np.atleast_1d(jr.iterations_per_system if nrhs else jr.niterations)
    assert np.all(np.abs(k1 - k2) <= 1)
    assert np.linalg.norm(got.x - jr.x) <= 1e-9 * np.linalg.norm(jr.x)


@pytest.mark.parametrize("l", [3, 4])
def test_deep_loop_bits_guard_monitor_depths(monkeypatch, l):
    """Deeper pipelines with the guard and the monitor on: the parent's
    bits and the same monitor lines."""
    from acg_torch.obs import monitor

    _, At, b = _pair(lambda m: m.poisson2d_5pt(14), l)
    o = SolverOptions(maxits=600, residual_rtol=1e-10, pipeline_depth=l,
                      check_every=2, guard_nonfinite=True, monitor_every=3)
    out = {}
    for name in ("new", "parent"):
        lines = []

        def sink(k, rr, lines=lines):
            lines.append((int(k), float(rr)))

        monitor.add_monitor_sink(sink)
        try:
            with monitor.muted(), monkeypatch.context() as mp:
                if name == "parent":
                    mp.setattr(tcg, "cg_pipelined_deep_while",
                               ref_cg_pipelined_deep_while)
                res = _solve(cg_pipelined_deep, At, b, options=o,
                             device="cpu")
        finally:
            monitor.remove_monitor_sink(sink)
        out[name] = (res, lines)
    _same(out["new"][0], out["parent"][0])
    assert out["new"][1] == out["parent"][1] and out["new"][1]


@pytest.mark.parametrize("nrhs", [0, 2])
def test_deep_dist_bits_against_the_parent_loop(monkeypatch, nrhs):
    """Four CPU shards (ppermute), replace_every=30: the static-buffer
    loop against the parent's dispatch, bit for bit; against acg_tpu's
    distributed deep solve, counts within 1."""
    from acg_tpu.solvers.cg_dist import cg_pipelined_deep_dist as jdist

    Aj, At, b = _pair(lambda m: m.poisson3d_7pt(8), 9, nrhs)
    o = dict(maxits=600, residual_rtol=1e-10, pipeline_depth=2,
             replace_every=30, check_every=2)
    kw = dict(nparts=4, devices=["cpu"] * 4)
    got = _solve(tcg_dist.cg_pipelined_deep_dist, At, b,
                 options=SolverOptions(**o), **kw)
    with monkeypatch.context() as mp:
        mp.setattr(tcg_dist, "cg_pipelined_deep_while",
                   ref_cg_pipelined_deep_while)
        want = _solve(tcg_dist.cg_pipelined_deep_dist, At, b,
                      options=SolverOptions(**o), **kw)
    _same(got, want)
    if not nrhs:
        part = tcg_dist.partition_graph(At, 4)
        jr = jdist(Aj, b, options=JOptions(**o), part=part)
        assert abs(got.niterations - jr.niterations) <= 1


def test_one_runner_spans_the_dispatches():
    """One BlockRunner a solve: its blocks' keys (length, first body's t
    or ring phase, check points) are few and shared by every dispatch:
    at most l + 1 + (2l+1)2l single-body keys at check_every=1."""
    from acg_torch.solvers import graphs

    _, At, b = _pair(lambda m: m.poisson3d_7pt(8), 2)
    keys = []
    real = graphs.BlockRunner.run

    def run(self, key, block):
        keys.append(key)
        return real(self, key, block)

    o = SolverOptions(maxits=600, residual_rtol=1e-10, pipeline_depth=2,
                      replace_every=30)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs.BlockRunner, "run", run)
        res = cg_pipelined_deep(At, b, options=o, device="cpu")
    ndisp = int(res.kernel_note.split(", ")[1].split()[0])
    assert ndisp >= 2
    assert len(set(keys)) <= 2 + 1 + 5 * 4
    assert res.stats.nloopopen == len(keys)
