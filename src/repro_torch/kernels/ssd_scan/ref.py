"""Oracle for the SSD chunk kernel: the sequential recurrence and the
plain blocked algorithm, and the blocked backward that the backward kernel
computes.

Re-exports the model-level reference so kernel tests and model tests
share a single source of truth.
"""

import torch

from repro_torch.models.mamba2 import ssd_chunked, ssd_naive

__all__ = ["ssd_naive", "ssd_chunked", "ssd_chunked_grads"]


def ssd_chunked_grads(x, log_a, B, C, dt, chunk: int, dy):
    """The gradients ``(dx, dlog_a, dB, dC, ddt)`` of ``<dy, ssd_chunked(x,
    log_a, B, C, dt, chunk)>``, in float32, written as the blocked formulas
    that ``csrc/ssd_scan_bwd.cu`` computes: the readable spec of that kernel.

    Per (batch row, chunk, head h of group g), with positions i, j in the
    chunk, ``cum`` the inclusive cumsum of log_a, ``T = cum[Q-1]``,
    ``xdt = dt x``, ``Gm = C Bᵀ``, ``Lm[i, j] = exp(cum_i - cum_j)`` for j <= i
    (else 0), S the state entering the chunk and dS' the gradient of the
    state leaving it:

    * the states: ``S`` by a forward walk over the chunks of the chunk-local
      states ``Σ_j e^{T-cum_j} B_j xdt_jᵀ``; ``dS'`` by a reverse walk,
      ``dS = e^T dS' + Σ_i e^{cum_i} C_i dy_iᵀ``, zero after the last chunk;
    * ``dxdt_j = Σ_{i>=j} Gm_ij Lm_ij dy_i + e^{T-cum_j} dS'ᵀ B_j``, and from
      it ``dx = dt dxdt``, ``ddt = x·dxdt``;
    * ``dGm = Σ_h Lm ∘ (dy xdtᵀ)``, summed over the group's heads before it
      meets B and C, so ``dC = dGm B + Σ_h e^{cum} dy Sᵀ`` and
      ``dB = dGmᵀ C + Σ_h e^{T-cum} xdt dS'ᵀ`` are one product each over the
      stacked (head, p) columns;
    * ``dcum_k = dy_k·y_k - xdt_k·dxdt_k``, plus at Q-1
      ``dT = e^T <S, dS'> + Σ_j xdt_j·(e^{T-cum_j} dS'ᵀ B_j)``; ``dlog_a``
      is its reverse cumsum in the chunk.  (The first two terms are the
      row and column sums of ``Gm ∘ Lm ∘ (dy xdtᵀ)`` and the two state
      terms of cum, gathered: ``y`` is recomputed in f32.  Both hold the
      diagonal term ``Gm_kk dy_k·xdt_k``; the kernel leaves it out of each,
      so that it cancels exactly.)

    x, dy [Bt, L, H, P]; log_a, dt [Bt, L, H]; B, C [Bt, L, N] (one group)
    or [Bt, L, G, N]; each gradient has its input's shape."""
    grouped = B.dim() == 4
    if not grouped:
        B, C = B.unsqueeze(2), C.unsqueeze(2)
    Bt, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    hg = H // G
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"sequence length {L} is not a multiple of the chunk {Q}")
    nc = L // Q
    f = torch.float32
    # blocked: [Bt, nc, Q, G, hg(, P)] and [Bt, nc, Q, G, N]
    xc = x.reshape(Bt, nc, Q, G, hg, P).to(f)
    dyc = dy.reshape(Bt, nc, Q, G, hg, P).to(f)
    dtc = dt.reshape(Bt, nc, Q, G, hg).to(f)
    cum = torch.cumsum(log_a.reshape(Bt, nc, Q, G, hg).to(f), dim=2)
    Bc = B.reshape(Bt, nc, Q, G, N).to(f)
    Cc = C.reshape(Bt, nc, Q, G, N).to(f)
    T = cum[:, :, -1]  # [Bt, nc, G, hg]
    xdt = xc * dtc[..., None]
    ecum = torch.exp(cum)
    erev = torch.exp(T[:, :, None] - cum)
    ch = cum.permute(0, 1, 3, 4, 2)  # [Bt, nc, G, hg, Q]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    Lm = torch.where(causal, torch.exp(torch.where(causal, ch[..., :, None] - ch[..., None, :],
                                                   0.0)), 0.0)  # [Bt, nc, G, hg, Qi, Qj]
    Gm = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)
    scores = Gm[:, :, :, None] * Lm

    # the states entering each chunk, and the gradients of those leaving it
    Sloc = torch.einsum("bcjgn,bcjgh,bcjghp->bcghnp", Bc, erev, xdt)
    Dloc = torch.einsum("bcign,bcigh,bcighp->bcghnp", Cc, ecum, dyc)
    S, dS = torch.zeros_like(Sloc[:, 0]), torch.zeros_like(Dloc[:, 0])
    S_in, dS_out = [], [None] * nc
    for c in range(nc):
        S_in.append(S)
        S = torch.exp(T[:, c])[..., None, None] * S + Sloc[:, c]
    for c in reversed(range(nc)):
        dS_out[c] = dS
        dS = torch.exp(T[:, c])[..., None, None] * dS + Dloc[:, c]
    S_in, dS_out = torch.stack(S_in, dim=1), torch.stack(dS_out, dim=1)  # [Bt, nc, G, hg, N, P]

    # xdt's gradient: the chunk's own outputs, then the state it leaves
    dxdt_inter = erev[..., None] * torch.einsum("bcjgn,bcghnp->bcjghp", Bc, dS_out)
    dxdt = torch.einsum("bcghij,bcighp->bcjghp", scores, dyc) + dxdt_inter
    dx = dxdt * dtc[..., None]
    ddt = (xc * dxdt).sum(-1)

    # B's and C's: the scores' gradient summed over the group's heads first
    dGm = (Lm * torch.einsum("bcighp,bcjghp->bcghij", dyc, xdt)).sum(3)  # [Bt, nc, G, Q, Q]
    dC = (torch.einsum("bcgij,bcjgn->bcign", dGm, Bc)
          + torch.einsum("bcigh,bcighp,bcghnp->bcign", ecum, dyc, S_in))
    dB = (torch.einsum("bcgij,bcign->bcjgn", dGm, Cc)
          + torch.einsum("bcjgh,bcjghp,bcghnp->bcjgn", erev, xdt, dS_out))

    # log_a's: through cum, reverse-summed in the chunk
    y = (torch.einsum("bcghij,bcjghp->bcighp", scores, xdt)
         + ecum[..., None] * torch.einsum("bcign,bcghnp->bcighp", Cc, S_in))
    dcum = (dyc * y).sum(-1) - (xdt * dxdt).sum(-1)  # [Bt, nc, Q, G, hg]
    dT = (torch.exp(T) * (S_in * dS_out).sum((-1, -2))
          + (xdt * dxdt_inter).sum(-1).sum(2))
    dcum[:, :, -1] += dT
    dlog_a = dcum.flip(2).cumsum(2).flip(2)

    dB, dC = dB.reshape(Bt, L, G, N), dC.reshape(Bt, L, G, N)
    if not grouped:
        dB, dC = dB[:, :, 0], dC[:, :, 0]
    return (dx.reshape(Bt, L, H, P), dlog_a.reshape(Bt, L, H), dB, dC, ddt.reshape(Bt, L, H))
