"""Plain PyTorch versions of the SSD scan kernel (Mamba-2's chunked state-space
duality), counterparts of ``repro.models.layers.ssd_chunked`` for one group
of B/C and of ``repro.kernels.ssd_scan.ref.ssd_ref_sequential``.

``ssd_chunked_ref`` walks the chunks in order as the reference's ``lax.scan``
does, one chunk's (b, c, c, h) tile live at a time, in float32, and rounds
each chunk's y to x's dtype where the reference does.
``ssd_ref_sequential`` is the O(s) recurrence, token by token: the ground
truth the tests hold both the plain version and the kernel to.
``ssd_scan_split_ref`` is the card's algorithm (csrc/ssd_scan.cu) in plain
PyTorch: C B^T once per (request, chunk), the head dim in slices, the state
carried transposed, and each operand derived in float32 split into hi + lo
before its product: bfloat16 pieces for bfloat16 inputs, TF32 pieces
(``cvt.rna.tf32`` emulated on the bits) otherwise.
``ssd_scan_bwd_ref`` is the scan's gradient as an explicit float32 chunked
pass (the plain version of csrc/ssd_scan_bwd.cuh): the states entering each
chunk, then a reverse walk over the chunks that carries the state's
cotangent.  ``ssd_scan_bwd_split_ref`` is the card's backward algorithm in
plain PyTorch: the state pass (each chunk's entering state and its
cotangent, stored as hi + lo pieces), the chunk-parallel pass with dB and
dC summed over each head group's heads in head order, and the groups'
parts summed in order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_chunked_ref(x, dt, A, B, C, *, chunk: int = 64):
    """x (b, s, h, p); dt (b, s, h) (already softplus'ed); A (h,) negative;
    B, C (b, s, n).  From a zero state.  -> (y (b, s, h, p) in x's dtype,
    final state (b, h, p, n) float32).  A ragged s is zero-padded to the
    chunk: dt = 0 there, so the state goes through the padding unchanged."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    A32 = A.float()
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s + pad, chunk):
        xc = x[:, c0:c0 + chunk].float()                       # (b, c, h, p)
        dtc = dt[:, c0:c0 + chunk].float()                     # (b, c, h)
        Bc = B[:, c0:c0 + chunk, None, :].float().expand(-1, -1, h, -1)
        Cc = C[:, c0:c0 + chunk, None, :].float().expand(-1, -1, h, -1)
        cum = torch.cumsum(dtc * A32, dim=1)
        # intra-chunk: exp taken only where j <= i.  Above the diagonal
        # cum_i - cum_j > 0 can overflow to inf, and autograd through a
        # where() that drops an inf still multiplies it by 0 (NaN), as
        # XLA's gradient of the reference's ``ssd_chunked`` does; so the
        # exponent is zeroed there first
        diff = cum[:, :, None, :] - cum[:, None, :, :]         # (b, c, c, h)
        keep = tri[None, :, :, None]
        L = torch.where(keep, torch.exp(torch.where(keep, diff, 0.0)), 0.0)
        att = torch.einsum("bchn,bdhn->bcdh", Cc, Bc) * L
        y = torch.einsum("bcdh,bdhp->bchp", att, xc * dtc[..., None])
        # the carried state's contribution
        y = y + torch.einsum("bchn,bhpn->bchp", Cc, state) * \
            torch.exp(cum)[..., None]
        # state update
        w = torch.exp(cum[:, -1:, :] - cum) * dtc              # (b, c, h)
        state = state * torch.exp(cum[:, -1])[:, :, None, None] + \
            torch.einsum("bchn,bchp->bhpn", Bc * w[..., None], xc)
        ys.append(y.to(x.dtype))
    return torch.cat(ys, 1)[:, :s], state


def ssd_ref_sequential(x, dt, A, B, C):
    """The direct recurrence, state_t = state_{t-1} exp(dt_t A) + dt_t x_t
    B_t^T, y_t = state_t C_t, in float32.  -> y (b, s, h, p) float32."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    x, dt, A, B, C = (t.float() for t in (x, dt, A, B, C))
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dA = torch.exp(dt[:, t] * A)                           # (b, h)
        upd = (dt[:, t, :, None] * x[:, t])[..., None] * B[:, t, None, None, :]
        state = state * dA[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t]))
    return torch.stack(ys, 1)


def tf32_rna(v):
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as float32: ``cvt.rna.tf32.f32``, by adding half of the dropped
    13 bits' range to the magnitude and clearing them."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(v):
    """v -> (hi, lo), TF32 values with hi + lo within 2**-22 |v| of v."""
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def split_bf16(v):
    """v -> (hi, lo), bfloat16 values (round to nearest even) with hi + lo
    within 2**-17 |v| of v."""
    hi = v.float().bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def split_f16(v):
    """v -> (hi, lo), float16 values (round to nearest even): the pieces of
    the backward kernel for float16 inputs."""
    hi = v.float().half().float()
    return hi, (v - hi).half().float()


SPLITS = {"tf32": split_tf32, "bf16": split_bf16, "f16": split_f16}


def slice_width(p: int) -> int:
    """The columns of the head dim one block of the card's scan takes."""
    return 32 if p % 32 == 0 else 16


def ssd_scan_split_ref(x, dt, A, B, C, *, chunk: int = 64, p_slice=None,
                       split=None, lo_terms: bool = True):
    """``ssd_chunked_ref``'s function by the card's algorithm, in float32:
    G = C B^T once per (request, chunk) for all heads; per slice of
    ``p_slice`` columns of p (default ``slice_width(p)``) the state carried
    as S^T (n x p_slice), and per chunk y_intra = (G . L . dt) x,
    y_state = (C S^T) . exp(cum) and the state's update, with each operand
    derived in float32 split into hi + lo (``split``: "bf16", the default
    for bfloat16 inputs, or "tf32", otherwise) and multiplied as
    hi . b + lo . b.  The update is B^T (x . w) with bfloat16 pieces (B^T
    enters as loaded) and (B^T . w) x with TF32 ones (B^T . w from
    registers).  ``lo_terms`` False drops the lo terms (the card's
    diagnostic).  -> (y (b, s, h, p) in x's dtype, final state (b, h, p, n)
    float32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    ps = p_slice or slice_width(p)
    if p % ps:
        raise ValueError(f"ssd_scan_split_ref: p={p} is no multiple of {ps}")
    kind = split or ("bf16" if x.dtype == torch.bfloat16 else "tf32")
    full = SPLITS[kind]
    split = full if lo_terms else (lambda v: (full(v)[0], torch.zeros_like(v)))
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    xf, dtf, A32 = x.float(), dt.float(), A.float()
    Bc = B.float().view(b, nc, chunk, n)
    Cc = C.float().view(b, nc, chunk, n)
    G = Cc @ Bc.transpose(-1, -2)                          # (b, nc, i, j)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    y = torch.empty((b, s + pad, h, p), dtype=x.dtype, device=x.device)
    state_t = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    for ci in range(nc):
        rows = slice(ci * chunk, (ci + 1) * chunk)
        xc, dtc = xf[:, rows], dtf[:, rows]                # (b, c, h, p), (b, c, h)
        cum = torch.cumsum(dtc * A32, dim=1)
        L = torch.where(tri[None, :, :, None],
                        torch.exp(cum[:, :, None] - cum[:, None]), 0.0)
        mh, ml = split(G[:, ci, :, :, None] * L * dtc[:, None])      # (b, i, j, h)
        w = torch.exp(cum[:, -1:] - cum) * dtc                      # (b, j, h)
        if kind == "tf32":
            wh, wl = split(Bc[:, ci, :, None, :] * w[..., None])     # (b, j, h, n)
        ecum, decay = torch.exp(cum), torch.exp(cum[:, -1])
        for p0 in range(0, p, ps):
            cols = slice(p0, p0 + ps)
            xs, st = xc[..., cols], state_t[..., cols]
            sh, sl = split(st)
            y_state = torch.einsum("bin,bhnp->bihp", Cc[:, ci], sh) + \
                torch.einsum("bin,bhnp->bihp", Cc[:, ci], sl)
            y_intra = torch.einsum("bijh,bjhp->bihp", mh, xs) + \
                torch.einsum("bijh,bjhp->bihp", ml, xs)
            y[:, rows, :, cols] = (y_intra + ecum[..., None] * y_state).to(x.dtype)
            if kind == "tf32":
                upd = torch.einsum("bjhn,bjhp->bhnp", wh, xs) + \
                    torch.einsum("bjhn,bjhp->bhnp", wl, xs)
            else:
                xh, xl = split(xs * w[..., None])                   # (b, j, h, ps)
                upd = torch.einsum("bjn,bjhp->bhnp", Bc[:, ci], xh) + \
                    torch.einsum("bjn,bjhp->bhnp", Bc[:, ci], xl)
            state_t[..., cols] = st * decay[:, :, None, None] + upd
    return y[:, :s], state_t.transpose(-1, -2).contiguous()


def _chunked(t, chunk: int, pad: int):
    """t (b, s, ...) zero-padded by ``pad`` rows -> (b, n_chunks, chunk, ...)
    in float32."""
    if pad:
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    return t.float().reshape(t.shape[0], -1, chunk, *t.shape[2:])


def _gram(C, B):
    """C_i . B_j over one chunk's rows: (b, c, n) x (b, c, n) -> (b, c, c)."""
    return torch.einsum("bin,bjn->bij", C, B)


def ssd_scan_bwd_ref(x, dt, A, B, C, dy, dfinal=None, *, chunk: int = 64):
    """Gradients of ``ssd_chunked_ref`` (from a zero state) given dy (b, s,
    h, p), the cotangent of y, and ``dfinal`` (b, h, p, n), that of the
    final state (None: zero).  -> (dx, ddt, dA, dB, dC) of the inputs'
    shapes; dx, dB and dC in x's dtype, ddt and dA float32.  No initial
    state's gradient: every caller starts the scan from zero.

    Per (request, head) and chunk, with rows i, j of the chunk, a_k = dt_k
    A, cum_i = sum_{k <= i} a_k, the state S entering the chunk, M_ij =
    (C_i . B_j) e^(cum_i - cum_j) dt_j and w_j = e^(cum_last - cum_j) dt_j
    for j <= i, and dS the cotangent of the state leaving it:
      dS_in = e^(cum_last) dS + sum_i e^(cum_i) dy_i C_i^T
      dx_j  = sum_{i >= j} M_ij dy_i + w_j dS B_j
      dC_i  = sum_{j <= i} e^(cum_i - cum_j) dt_j (dy_i . x_j) B_j
              + e^(cum_i) S^T dy_i
      dB_j  = sum_{i >= j} e^(cum_i - cum_j) dt_j (dy_i . x_j) C_i
              + w_j dS^T x_j
    (dB and dC summed over the heads: one group), ddt_j's direct part
    sum_{i >= j} (C_i . B_j) e^(cum_i - cum_j) (dy_i . x_j)
    + e^(cum_last - cum_j) x_j^T dS B_j, and through cum: with dcum_i
    collecting +sum_j T_ij at i and -sum_i T_ij at j (T_ij = M_ij (dy_i .
    x_j)), e^(cum_i) dy_i^T S C_i at i, e^(cum_last) <dS, S> + sum_j w_j
    x_j^T dS B_j at the last row and -w_j x_j^T dS B_j at j, ddt_k +=
    A sum_{i >= k} dcum_i and dA += sum_k dt_k sum_{i >= k} dcum_i.  A
    ragged s is zero-padded as ``ssd_chunked_ref`` pads it: dt = 0 and
    dy = 0 there, so the padded rows contribute nothing."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    xc, dtc, Bc, Cc, dyc = (_chunked(t, chunk, pad) for t in (x, dt, B, C, dy))
    nc = xc.shape[1]
    A32 = A.float()
    cum = torch.cumsum(dtc * A32, dim=2)                        # (b, nc, c, h)
    last = cum[:, :, -1]                                        # (b, nc, h)
    w = torch.exp(last[:, :, None] - cum) * dtc                 # (b, nc, c, h)
    # the states entering each chunk
    states, S = [], torch.zeros((b, h, p, n), dtype=torch.float32,
                                device=x.device)
    for ci in range(nc):
        states.append(S)
        S = S * torch.exp(last[:, ci])[..., None, None] + torch.einsum(
            "bjh,bjhp,bjn->bhpn", w[:, ci], xc[:, ci], Bc[:, ci])
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    dS = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) \
        if dfinal is None else dfinal.float()
    dx, ddt = torch.empty_like(xc), torch.empty_like(dtc)
    dB, dC = torch.empty_like(Bc), torch.empty_like(Cc)
    dA = torch.zeros_like(A32)
    for ci in reversed(range(nc)):
        xi, dti, Bi, Ci, dyi = xc[:, ci], dtc[:, ci], Bc[:, ci], Cc[:, ci], \
            dyc[:, ci]
        cm, wi, S = cum[:, ci], w[:, ci], states[ci]
        # E_ij = e^(cum_i - cum_j) where j <= i (inf above, never used)
        E = torch.where(tri[None, :, :, None],
                        torch.exp(cm[:, :, None] - cm[:, None]), 0.0)
        G = _gram(Ci, Bi)                                       # C_i . B_j
        D = torch.einsum("bihp,bjhp->bijh", dyi, xi)            # dy_i . x_j
        K = E * dti[:, None]                                    # E_ij dt_j
        M = G[..., None] * K
        Q = D * K
        T = M * D
        ecum = torch.exp(cm)
        dSB = torch.einsum("bhpn,bjn->bjhp", dS, Bi)            # dS B_j
        xdS = torch.einsum("bjhp,bhpn->bjhn", xi, dS)           # dS^T x_j
        dyS = torch.einsum("bihp,bhpn->bihn", dyi, S)           # S^T dy_i
        v = torch.einsum("bjhn,bjn->bjh", xdS, Bi)              # x_j^T dS B_j
        u = ecum * torch.einsum("bihn,bin->bih", dyS, Ci)       # dy_i^T S C_i
        dx[:, ci] = torch.einsum("bijh,bihp->bjhp", M, dyi) + wi[..., None] * dSB
        dC[:, ci] = torch.einsum("bijh,bjn->bin", Q, Bi) + \
            torch.einsum("bih,bihn->bin", ecum, dyS)
        dB[:, ci] = torch.einsum("bijh,bin->bjn", Q, Ci) + \
            torch.einsum("bjh,bjhn->bjn", wi, xdS)
        direct = torch.einsum("bij,bijh->bjh", G, E * D) + \
            torch.exp(last[:, ci, None] - cm) * v
        dcum = T.sum(2) - T.sum(1) + u - wi * v
        dcum[:, -1] += torch.exp(last[:, ci]) * (dS * S).sum((-1, -2)) + \
            (wi * v).sum(1)
        rc = dcum.flip(1).cumsum(1).flip(1)                     # sum_{i >= k}
        ddt[:, ci] = direct + A32 * rc
        dA += (dti * rc).sum((0, 1))
        dS = dS * torch.exp(last[:, ci])[..., None, None] + \
            torch.einsum("bih,bihp,bin->bhpn", ecum, dyi, Ci)
    rows = lambda t: t.reshape(b, nc * chunk, *t.shape[3:])[:, :s]
    return (rows(dx).to(x.dtype), rows(ddt), dA, rows(dB).to(x.dtype),
            rows(dC).to(x.dtype))


def head_groups(b: int, n_chunks: int, h: int, sms: int = 132) -> int:
    """How many blocks of the card's backward chunk pass share one (request,
    chunk)'s heads: as many as keep the grid within one wave of one block an
    SM (``sms``, 132 on an H100), 1 .. h."""
    return max(1, min(h, sms // max(1, b * n_chunks)))


def ssd_scan_bwd_split_ref(x, dt, A, B, C, dy, dfinal=None, *, chunk: int = 64,
                           split=None, groups=None):
    """``ssd_scan_bwd_ref``'s function by the card's algorithm, in float32:
    1. the state pass: per (request, head) the chunks' entering states S
       (forward, S <- e^(cum_last) S + (x . w)^T B) and the cotangents dS of
       the states leaving them (backward from ``dfinal``, dS <- e^(cum_last)
       dS + (dy . e^cum)^T C), the derived operand of each update split into
       hi + lo, and S, dS kept as their hi + lo pieces;
    2. the chunk pass per (request, chunk) and head group (``groups``,
       default ``head_groups(b, n_chunks, h)``): per head in order, D = dy
       x^T, M = G . K and Q = D . K (K_ij = e^(cum_i - cum_j) dt_j, j <= i,
       G = C B^T), dx = w . (B dS^T) + M^T dy (M split), dC += e^cum . (dy S)
       and dB += w . (x dS) over the pieces, u, v, dcum's sums, ddt and a
       part of dA; then, once, dC += Q_sum B and dB += Q_sum^T C (Q_sum, the
       group's sum of Q over its heads, split);
    3. the groups' parts of dB and dC summed in group order, dA's parts in
       (request, chunk) order.
    ``split``: the pieces, "bf16" (the default), or "f16" (the default for
    float16 inputs: the kernel splits in the input dtype).  x, dy, B and C
    enter the products as given.  -> (dx, ddt, dA, dB, dC) as
    ``ssd_scan_bwd_ref`` gives them."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    sp = SPLITS[split or ("f16" if x.dtype == torch.float16 else "bf16")]
    pad = (-s) % chunk
    xc, dtc, Bc, Cc, dyc = (_chunked(t, chunk, pad) for t in (x, dt, B, C, dy))
    nc = xc.shape[1]
    A32 = A.float()
    cum = torch.cumsum(dtc * A32, dim=2)                        # (b, nc, c, h)
    last = cum[:, :, -1]                                        # (b, nc, h)
    ecum = torch.exp(cum)
    w = torch.exp(last[:, :, None] - cum) * dtc

    def two(eq, pieces, other):
        return torch.einsum(eq, pieces[0], other) + torch.einsum(eq, pieces[1], other)

    # 1. the state pass
    states, S = [], torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    for ci in range(nc):
        states.append(sp(S))
        S = S * torch.exp(last[:, ci])[..., None, None] + two(
            "bjhp,bjn->bhpn", sp(xc[:, ci] * w[:, ci][..., None]), Bc[:, ci])
    dstates = [None] * nc
    dS = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) \
        if dfinal is None else dfinal.float()
    for ci in reversed(range(nc)):
        dstates[ci] = sp(dS)
        dS = dS * torch.exp(last[:, ci])[..., None, None] + two(
            "bihp,bin->bhpn", sp(dyc[:, ci] * ecum[:, ci][..., None]), Cc[:, ci])
    # (b, nc, h, p, n) pieces
    Sp = [torch.stack([st[k] for st in states], 1) for k in range(2)]
    dSp = [torch.stack([st[k] for st in dstates], 1) for k in range(2)]

    # 2. the chunk pass
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    keep = tri[None, None, :, :, None]
    diff = cum[:, :, :, None] - cum[:, :, None]                 # (b, nc, i, j, h)
    E = torch.where(keep, torch.exp(torch.where(keep, diff, 0.0)), 0.0)
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    dx, ddt = torch.empty_like(xc), torch.empty_like(dtc)
    dA_part = torch.empty((b, nc, h), dtype=torch.float32, device=x.device)
    HG = groups or head_groups(b, nc, h)
    parts_c, parts_b = [], []
    for grp in range(HG):
        dC_acc = torch.zeros_like(Cc)
        dB_acc = torch.zeros_like(Bc)
        Q_sum = torch.zeros((b, nc, chunk, chunk), dtype=torch.float32,
                            device=x.device)
        for hd in range(grp * h // HG, (grp + 1) * h // HG):
            xh, dyh, dth = xc[..., hd, :], dyc[..., hd, :], dtc[..., hd]
            Eh, ech, wh = E[..., hd], ecum[..., hd], w[..., hd]
            Sh = [t[:, :, hd] for t in Sp]                     # (b, nc, p, n)
            dSh = [t[:, :, hd] for t in dSp]
            D = torch.einsum("bcip,bcjp->bcij", dyh, xh)
            K = Eh * dth[:, :, None, :]
            M = G * K
            Q = D * K
            T = M * D
            Q_sum = Q_sum + Q
            dCt = two("bcpn,bcip->bcin", Sh, dyh)
            dBt = two("bcpn,bcjp->bcjn", dSh, xh)
            dC_acc = dC_acc + ech[..., None] * dCt
            dB_acc = dB_acc + wh[..., None] * dBt
            u = ech * (dCt * Cc).sum(-1)
            v = (dBt * Bc).sum(-1)
            dx[..., hd, :] = wh[..., None] * two("bcpn,bcjn->bcjp", dSh, Bc) + \
                two("bcij,bcip->bcjp", sp(M), dyh)
            dss = ((Sh[0] + Sh[1]) * (dSh[0] + dSh[1])).sum((-1, -2))
            dcum = T.sum(-1) - T.sum(-2) + u - wh * v
            dcum[..., -1] += ech[..., -1] * dss + (wh * v).sum(-1)
            rc = dcum.flip(-1).cumsum(-1).flip(-1)
            ddt[..., hd] = (G * Eh * D).sum(-2) + \
                torch.exp(last[..., hd, None] - cum[..., hd]) * v + A32[hd] * rc
            dA_part[..., hd] = (dth * rc).sum(-1)
        qs = sp(Q_sum)
        parts_c.append(dC_acc + two("bcij,bcjn->bcin", qs, Bc))
        parts_b.append(dB_acc + two("bcij,bcin->bcjn", qs, Cc))

    # 3. the groups' and the (request, chunk) parts, each in order
    dC, dB = parts_c[0], parts_b[0]
    for k in range(1, HG):
        dC, dB = dC + parts_c[k], dB + parts_b[k]
    flat = dA_part.reshape(b * nc, h)
    dA = flat[0]
    for k in range(1, b * nc):
        dA = dA + flat[k]
    rows = lambda t: t.reshape(b, nc * chunk, *t.shape[3:])[:, :s]
    return (rows(dx).to(x.dtype), rows(ddt), dA, rows(dB).to(x.dtype),
            rows(dC).to(x.dtype))
