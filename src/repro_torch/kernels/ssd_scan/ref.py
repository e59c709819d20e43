"""Plain PyTorch versions of the SSD scan kernel (Mamba-2's chunked state-space
duality), counterparts of ``repro.models.layers.ssd_chunked`` for one group
of B/C and of ``repro.kernels.ssd_scan.ref.ssd_ref_sequential``.

``ssd_chunked_ref`` walks the chunks in order as the reference's ``lax.scan``
does, one chunk's (b, c, c, h) tile live at a time, in float32, and rounds
each chunk's y to x's dtype where the reference does.
``ssd_ref_sequential`` is the O(s) recurrence, token by token: the ground
truth the tests hold both the plain version and the kernel to.
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
        # intra-chunk: exp only selected where j <= i (inf above, never used)
        diff = cum[:, :, None, :] - cum[:, None, :, :]         # (b, c, c, h)
        L = torch.where(tri[None, :, :, None], torch.exp(diff), 0.0)
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
