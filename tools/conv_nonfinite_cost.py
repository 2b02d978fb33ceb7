#!/usr/bin/env python3
"""The cost of fdiff_conv's non-finite repair on the card.

    python3 tools/conv_nonfinite_cost.py

Times fdiff.conv_direct_nonfinite (the planes split by nan_to_num, the
codes from the non-finite part) against its first form (isfinite masks and
nested torch.where, kept here) and K9 alone, on 4096^2 operands of the
conv step's shape (6 planes, 17 x 17 taps, J and 6 background planes), by
CUDA events in one process, each form twice in alternation; checks that
the two forms agree bit for bit, on finite planes and on planes with NaN
and +-inf pixels.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402
from sfft_tpu_torch.core import fdiff  # noqa: E402

S, NAN = fdiff._NF_SLOT, fdiff._NF_NAN


def first_form(planes, taps, wrap=True, J=None, ST=None, b=None, scale=1.0):
    """conv_direct_nonfinite's first form, without scaling planes."""
    fin = torch.isfinite(planes)
    out = fdiff.conv_direct(torch.where(fin, planes, 0.0), taps, wrap, J, ST, b, None, None,
                            scale)
    tcode = torch.where(taps > 0, 1.0, torch.where(taps < 0, S, NAN))
    code = torch.where(torch.isnan(planes), NAN, torch.where(planes > 0, 1.0, S))
    r = fdiff.conv_direct(torch.where(fin, 0.0, code).to(planes.dtype), tcode.to(planes.dtype),
                          wrap)
    nan = r >= NAN
    hi = torch.floor(r / S ** 2)
    mid = torch.floor((r - hi * S ** 2) / S)
    lo = r - hi * S ** 2 - mid * S
    pos, neg = (lo > 0) | (hi > 0), mid > 0
    T = torch.where(nan | (pos & neg), torch.nan,
                    torch.where(pos, torch.inf, torch.where(neg, -torch.inf, 0.0))).to(out.dtype)
    return torch.where(T == 0, out, out - scale * T)


def ms(fn, reps=7, inner=3):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / inner)
    ts.sort()
    return ts[len(ts) // 2], ts[0], ts[-1]


def main():
    if not torch.cuda.is_available():
        sys.exit("conv_nonfinite_cost: needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(16)
    P = 100 + 10 * torch.randn((6, 4096, 4096), dtype=torch.float64, device="cuda", generator=g)
    T = torch.randn((6, 17, 17), dtype=torch.float64, device="cuda", generator=g) * 0.01
    J = torch.randn((4096, 4096), dtype=torch.float64, device="cuda", generator=g)
    ST = torch.randn((6, 4096, 4096), dtype=torch.float64, device="cuda", generator=g)
    b = torch.randn(6, dtype=torch.float64, device="cuda", generator=g)
    kw = dict(J=J, ST=ST, b=b, scale=1.3)
    a1 = fdiff.conv_direct_nonfinite(P, T, True, **kw)
    a0 = first_form(P, T, True, **kw)
    Pn = P.clone()
    Pn[:, 100, 200], Pn[:, 3000, 7], Pn[2, 50, 4000] = float("nan"), float("inf"), -float("inf")
    n1 = fdiff.conv_direct_nonfinite(Pn, T, True, **kw)
    n0 = first_form(Pn, T, True, **kw)
    torch.cuda.synchronize()
    print("bits all-finite:", torch.equal(a1, a0), " with non-finite pixels:",
          torch.equal(torch.nan_to_num(n1, nan=7.0), torch.nan_to_num(n0, nan=7.0)),
          "non-finite pixels", int((~torch.isfinite(n1)).sum()))
    forms = {"K9 alone": fdiff.conv_direct, "first form": first_form,
             "conv_direct_nonfinite": fdiff.conv_direct_nonfinite}
    for label in ("K9 alone", "first form", "conv_direct_nonfinite", "K9 alone",
                  "conv_direct_nonfinite", "first form"):
        m = ms(lambda: forms[label](P, T, True, **kw))
        print(f"{label}: median {m[0]:.3f} ms (min {m[1]:.3f}, max {m[2]:.3f}), CUDA events, "
              f"7 x 3 calls")


if __name__ == "__main__":
    main()
