"""Normal-equation assembly from correlation tables via static gathers
(counterpart of sfft_tpu/core/assemble.py).

The delta-function kernel basis makes every basis image either
  shift(I*beta_ij, (a, b)) - I*beta_ij   (non-center offsets, KERNEL basis)
  I*sigma_ij                             (center offset, SCALING basis)
where sigma == beta in ENTANGLED mode. So every LHMAT entry is a signed sum
of <= 4 gathers from cross-correlation lag tables:

  LH = c1_r c1_c Pbb(a8-a) + c1_r c0_c Pbb(a8) + c1_r cs_c Pbs(a8)
     + c0_r c1_c Pbb(-a)   + c0_r c0_c Pbb(0)  + c0_r cs_c Pbs(0)
     + cs_r c1_c Psb(-a)   + cs_r c0_c Psb(0)  + cs_r cs_c Pss

with c1 = [offset != center], c0 = -c1, cs = 1 - c1, and Psb the lag-mirror of
Pbs. This reproduces the reference FillLS_{OMG,GAM,PSI,PHI,THE,DEL} kernels
(sfft/sfftcore/SFFTConfigure.py:197-688) in ENTANGLED and SEPARATE modes.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from sfft_tpu_torch.config import SFFTConfig
from sfft_tpu_torch.core.indices import ab_tables
from sfft_tpu_torch.core.statics import Static, table


class GreekTables(NamedTuple):
    """Scaled Pre tables (reference PreOMG etc. values).

    Pbb:  (Fij, Fij, 4w0+1, 4w1+1)  CC(I*beta_a, I*beta_b), lag idx l+2w
    Pbs:  (Fij, Fij, 2w0+1, 2w1+1)  CC(I*beta_a, I*sigma_b)
    Pss:  (Fij, Fij)                CC(I*sigma_a, I*sigma_b) at lag 0
    Pgb:  (Fij, Fpq, 2w0+1, 2w1+1)  CC(I*beta_a, T_q)
    Pgs:  (Fij, Fpq)                CC(I*sigma_a, T_q) at lag 0
    Ptb:  (Fij, 2w0+1, 2w1+1)       CC(I*beta_a, J)
    Pts:  (Fij,)                    CC(I*sigma_a, J) at lag 0
    Pphi: (Fpq, Fpq)                CC(T_p, T_q) at lag 0
    Pdel: (Fpq,)                    CC(T_p, J) at lag 0
    """

    Pbb: torch.Tensor
    Pbs: torch.Tensor
    Pss: torch.Tensor
    Pgb: torch.Tensor
    Pgs: torch.Tensor
    Ptb: torch.Tensor
    Pts: torch.Tensor
    Pphi: torch.Tensor
    Pdel: torch.Tensor


def _plan_entry(cfg: SFFTConfig, name: str) -> np.ndarray:
    return _gather_plan(cfg)[name]


@lru_cache(maxsize=64)
def _gather_plan(cfg: SFFTConfig):
    a, b, nz = ab_tables(cfg)
    w0, w1 = cfg.w0, cfg.w1
    R1o = 4 * w1 + 1
    r1 = 2 * w1 + 1

    c1 = nz.astype(np.float64)
    c0 = -c1
    cs = 1.0 - c1

    def oflat(la, lb):
        return ((la + 2 * w0) * R1o + (lb + 2 * w1)).astype(np.int64)

    def gflat(la, lb):
        return ((la + w0) * r1 + (lb + w1)).astype(np.int64)

    z = np.zeros_like(a)
    return dict(
        c1=c1, c0=c0, cs=cs,
        omg_cross=oflat(a[:, None] - a[None, :], b[:, None] - b[None, :]),
        omg_row=oflat(a, b), omg_col=oflat(-a, -b),
        omg_zero=int(oflat(z[:1], z[:1])[0]),
        g_row=gflat(a, b), g_col_neg=gflat(-a, -b),
        g_zero=int(gflat(z[:1], z[:1])[0]),
    )


def _omg_chunk(Fab: int) -> int:
    """Row-offset chunk size for the memory-capped OMG assembly: the largest
    divisor of Fab not exceeding 64."""
    best = 1
    for d in range(1, min(Fab, 64) + 1):
        if Fab % d == 0:
            best = d
    return best


def assemble_system(cfg: SFFTConfig, t: GreekTables,
                    out_dtype=None,
                    reg_terms=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build (LHMAT, RHb) of the NEQ x NEQ system, identical in value to the
    reference's FillLS output for the active scaling mode.

    out_dtype: optional narrower output dtype; the delta-basis cancellation
    still happens in table precision and the OMG block is then built in
    row-offset chunks, so no full-precision NEQ^2 intermediate exists (as it
    also is whenever Fij*Fab >= 8192).
    reg_terms: optional Kronecker factors [(M (Fij,Fij), R (Fab,Fab))] of
    lambda*REGMAT, added inside the OMG row construction.
    Tables with a leading pair axis (the batched step) give (B, NEQ, NEQ)
    and (B, NEQ): the same gathers and elementwise sums for the batch, each
    pair's bits those of its single call.
    """
    p = _gather_plan(cfg)
    Fij, Fpq, Fab = cfg.Fij, cfg.Fpq, cfg.Fab
    lead = tuple(t.Pbb.shape[:-4])     # () or (B,): the pair axis
    dt = t.Pbb.dtype
    dev = t.Pbb.device
    odt = out_dtype if out_dtype is not None else dt

    def const(name, dtype=dt):
        # the plan's static tables, built and uploaded once (core/statics.py)
        return table(Static(_plan_entry, (cfg, name)), dev, dtype)

    c1 = const("c1")
    c0 = const("c0")
    cs = const("cs")

    # ---- OMG block -----------------------------------------------------
    Pbbf = t.Pbb.reshape(lead + (Fij, Fij, -1))
    Pbsf = t.Pbs.reshape(lead + (Fij, Fij, -1))
    Psbf = Pbsf.transpose(-3, -2)
    bb_zero = Pbbf[..., p["omg_zero"]][..., None, None]
    bs_zero = Pbsf[..., p["g_zero"]][..., None, None]
    sb_zero = Psbf[..., p["g_zero"]][..., None, None]
    ss = t.Pss[..., None, None]
    k1, k0, ks = c1[None, :], c0[None, :], cs[None, :]
    # column-indexed terms (row-independent)
    bb_col = Pbbf[..., const("omg_col", torch.long)][..., None, :]
    sb_colneg = Psbf[..., const("g_row", torch.long)][..., None, :]
    col_part = (k1 * bb_col + k0 * bb_zero + ks * bs_zero)      # x c0 row
    scl_part = (k1 * sb_colneg + k0 * sb_zero + ks * ss)        # x cs row

    oc = const("omg_cross", torch.long)
    orow = const("omg_row", torch.long)
    grow = const("g_row", torch.long)
    CH = _omg_chunk(Fab) if (odt != dt or Fij * Fab >= 8192) else Fab

    reg = None
    if reg_terms is not None:
        reg = [tuple(torch.as_tensor(x, dtype=dt, device=dev) for x in MR)
               for MR in reg_terms]

    def rows_for(idx):
        """OMG rows for a row-offset subset idx (CH,): (Fij, CH, Fij*Fab)."""
        bb_cross = Pbbf[..., oc[idx]]                           # (F,F,CH,Fab)
        bb_row = Pbbf[..., orow[idx]][..., None]
        bs_row = Pbsf[..., grow[idx]][..., None]
        r1 = c1[idx][:, None]
        r0 = c0[idx][:, None]
        rs = cs[idx][:, None]
        blk = (r1 * (k1 * bb_cross + k0 * bb_row + ks * bs_row)
               + r0 * col_part + rs * scl_part)
        if reg is not None:
            for M, R in reg:
                blk = blk + M[:, :, None, None] * R[idx][None, None, :, :]
        return blk.transpose(-3, -2).reshape(lead + (Fij, len(idx), Fij * Fab)).to(odt)

    if CH == Fab:
        omg = rows_for(torch.arange(Fab, device=dev)).reshape(lead + (Fij * Fab, Fij * Fab))
    else:
        chunks = [rows_for(torch.arange(s, s + CH, device=dev)) for s in range(0, Fab, CH)]
        omg = torch.stack(chunks, dim=-3).reshape(lead + (Fij * Fab, Fij * Fab))

    # ---- GAM block: rows (i8j8, a8b8), cols pq -------------------------
    Gbf = t.Pgb.reshape(lead + (Fij, Fpq, -1))
    gam = (
        c1[None, None, :] * Gbf[..., grow]
        + c0[None, None, :] * Gbf[..., p["g_zero"]][..., None]
        + cs[None, None, :] * t.Pgs[..., None]
    )
    # the PSI block is the transpose layout of the same values:
    # CC(T, I*beta)[-a] == Pgb(a); CC(T, I*sigma)[0] == Pgs
    psi = gam.transpose(-3, -2).reshape(lead + (Fpq, Fij * Fab))
    gam = gam.transpose(-2, -1).reshape(lead + (Fij * Fab, Fpq))

    # ---- THE / DEL RHS -------------------------------------------------
    Tbf = t.Ptb.reshape(lead + (Fij, -1))
    the = (
        c1[None, :] * Tbf[..., grow]
        + c0[None, :] * Tbf[..., p["g_zero"]][..., None]
        + cs[None, :] * t.Pts[..., None]
    ).reshape(lead + (Fij * Fab,))

    lhs = torch.cat([
        torch.cat([omg, gam.to(odt)], dim=-1),
        torch.cat([psi.to(odt), t.Pphi.to(odt)], dim=-1),
    ], dim=-2)
    rhs = torch.cat([the.to(odt), t.Pdel.to(odt)], dim=-1)
    return lhs, rhs


def entangled_tables(
    cfg: SFFTConfig,
    Comg: torch.Tensor,
    Cgam: torch.Tensor,
    Cthe: torch.Tensor,
    Cphi: torch.Tensor,
    Cdel: torch.Tensor,
) -> GreekTables:
    """Derive the sigma tables from the beta tables when sigma == beta:
    Pbs is the central +-w window of Pbb; lag-0 entries come from the
    centers. The tables may carry a leading pair axis."""
    w0, w1 = cfg.w0, cfg.w1
    win0 = slice(w0, 3 * w0 + 1)
    win1 = slice(w1, 3 * w1 + 1)
    Pbs = Comg[..., win0, win1]
    Pss = Comg[..., 2 * w0, 2 * w1]
    Pgs = Cgam[..., w0, w1]
    Pts = Cthe[..., w0, w1]
    return GreekTables(
        Pbb=Comg, Pbs=Pbs, Pss=Pss, Pgb=Cgam, Pgs=Pgs,
        Ptb=Cthe, Pts=Pts, Pphi=Cphi, Pdel=Cdel,
    )
