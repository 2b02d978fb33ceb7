"""Grid-wise spatially-varying convolution (counterpart of
sfft_tpu/post/grid_convolve.py), in torch.

Reference: BSpline_GridConvolve (sfft/BSplineSFFT.py:4870-5008) — label map ->
per-tile extended cutout -> convolve -> stitch.

For the (typical) uniform tile grid all tiles have one shape, so the whole
operation is one batched call over a stack of halo-extended tiles: a grouped
direct convolution (``torch.nn.functional.conv2d``, one kernel per tile) for
small kernels, or one batched rfft2 convolution for large ones. An arbitrary
label map takes a loop over segments with the same per-segment semantics,
each through utils/convolve.convolve2d (the K9 kernel on the card).
Everything runs in float64 on `device` (the CUDA card unless the caller
names another); the functions return tensors, the GSVC facade a numpy array.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sfft_tpu_torch.post.fftkits import as_f64


def make_tile_grid(N0: int, N1: int, TiHW: int) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform tile allocation exactly as the reference's canonical example
    (sfft/BSplineSFFT.py:4884-4899): tile size TiN = 2*TiHW+1, raster labels.
    Returns (AllocatedL (N0, N1) int labels, XY_TiC (Nseg, 2) tile centers in
    FortranCoor)."""
    TiN = 2 * TiHW + 1
    lab = 0
    AllocatedL = np.zeros((N0, N1), dtype=int)
    XY_TiC = []
    for xs in np.arange(0, N0, TiN):
        xe = min(xs + TiN, N0)
        for ys in np.arange(0, N1, TiN):
            ye = min(ys + TiN, N1)
            AllocatedL[xs:xe, ys:ye] = lab
            XY_TiC.append([0.5 + xs + (xe - xs) / 2.0, 0.5 + ys + (ye - ys) / 2.0])
            lab += 1
    return AllocatedL, np.array(XY_TiC)


def _finite(img: torch.Tensor, fill: float) -> torch.Tensor:
    return torch.where(torch.isfinite(img), img, torch.full_like(img, fill))


def grid_convolve_uniform(
    image,
    ker_stack,
    TiHW: int,
    nan_fill_value: float = 0.0,
    normalize_kernel: bool = True,
    use_fft: Optional[bool] = None,
    device=None,
) -> torch.Tensor:
    """Spatially-varying convolution on a uniform tile grid, fully batched.

    ker_stack: (Nseg, L0, L1) with Nseg = ntx * nty raster tiles (the
    make_tile_grid ordering). Border tiles may be smaller than TiN; they are
    handled by padding the image to a full tile multiple (zero fill — matching
    the reference's boundary='fill' cutout convolution).

    Two batched paths:
      direct — one grouped conv2d over the halo-tile stack (small kernels)
      fft    — one batched rfft2 convolution over zero-padded halo tiles
               (large kernels, e.g. 400-px decorrelation kernels)
    use_fft=None picks by kernel area.
    """
    img = as_f64(image, device)
    dev = img.device
    kers = as_f64(ker_stack, dev)
    N0, N1 = img.shape
    Nseg, L0, L1 = kers.shape
    w0, w1 = (L0 - 1) // 2, (L1 - 1) // 2
    TiN = 2 * TiHW + 1
    ntx = -(-N0 // TiN)
    nty = -(-N1 // TiN)
    if Nseg != ntx * nty:
        raise ValueError(f"{Nseg} kernels for a grid of {ntx} x {nty} tiles")
    if use_fft is None:
        use_fft = (L0 * L1) > 33 * 33

    img = _finite(img, nan_fill_value)
    if normalize_kernel:
        kers = kers / kers.sum(dim=(1, 2), keepdim=True)

    # pad to tile multiple + conv halo, then cut the halo tiles
    # (Nseg, TiN + 2w0, TiN + 2w1) in raster order
    P0, P1 = ntx * TiN, nty * TiN
    imgp = F.pad(img, (w1, P1 - N1 + w1, w0, P0 - N0 + w0))
    E0, E1 = TiN + 2 * w0, TiN + 2 * w1
    tiles = imgp.unfold(0, E0, TiN).unfold(1, E1, TiN).reshape(Nseg, E0, E1)

    if use_fft:
        # batched circular FFT conv on zero-padded tiles: the halo already
        # contains the real data the kernel can reach, and the outer zero pad
        # prevents wrap-around, so the VALID center equals the direct conv
        F0 = int(2 ** np.ceil(np.log2(E0 + L0 - 1)))
        F1 = int(2 ** np.ceil(np.log2(E1 + L1 - 1)))
        kimg = torch.roll(F.pad(kers, (0, F1 - L1, 0, F0 - L0)), shifts=(-w0, -w1),
                          dims=(1, 2))                                   # CSZ
        tilesp = F.pad(tiles, (0, F1 - E1, 0, F0 - E0))
        conv = torch.fft.irfft2(torch.fft.rfft2(tilesp) * torch.fft.rfft2(kimg), s=(F0, F1))
        tiles_out = conv[:, w0 : w0 + TiN, w1 : w1 + TiN]
    else:
        # one kernel per tile: tiles as channels, a grouped convolution
        # (conv2d correlates, so the kernels are flipped)
        tiles_out = F.conv2d(tiles[None], torch.flip(kers, dims=(1, 2))[:, None],
                             groups=Nseg)[0]

    stitched = tiles_out.reshape(ntx, nty, TiN, TiN).permute(0, 2, 1, 3).reshape(P0, P1)
    return stitched[:N0, :N1]


def grid_convolve_labels(
    image,
    AllocatedL: np.ndarray,
    ker_stack,
    nan_fill_value: float = 0.0,
    normalize_kernel: bool = True,
    use_fft: bool = False,
    device=None,
) -> torch.Tensor:
    """Arbitrary label map (reference GSVC semantics: per-segment extended
    cutout with zero-fill boundary, stitch the interior back). use_fft is
    accepted for the reference's signature; each segment convolves directly
    through utils/convolve.convolve2d (K9 on the card), as sfft_tpu's does."""
    from sfft_tpu_torch.utils.convolve import convolve2d

    img = _finite(as_f64(image, device), nan_fill_value)
    kers = np.asarray(ker_stack.detach().cpu() if isinstance(ker_stack, torch.Tensor)
                      else ker_stack, dtype=np.float64)
    N0, N1 = img.shape
    Nseg, L0, L1 = kers.shape
    w0, w1 = (L0 - 1) // 2, (L1 - 1) // 2
    IBx, IBy = w0 + 1, w1 + 1
    out = torch.zeros((N0, N1), dtype=torch.float64, device=img.device)
    for idx in range(Nseg):
        lX, lY = np.where(AllocatedL == idx)
        xs, xe = lX.min(), lX.max()
        ys, ye = lY.min(), lY.max()
        xEs, xEe = max(0, xs - IBx), min(N0 - 1, xe + IBx)
        yEs, yEe = max(0, ys - IBy), min(N1 - 1, ye + IBy)
        cut = img[xEs : xEe + 1, yEs : yEe + 1]
        conv = convolve2d(cut, kers[idx], boundary="fill", fill_value=0.0,
                          normalize_kernel=normalize_kernel, nan_treatment="fill")
        out[xs : xe + 1, ys : ye + 1] = conv[xs - xEs : xs - xEs + (xe + 1 - xs),
                                             ys - yEs : ys - yEs + (ye + 1 - ys)]
    return out


class BSplineGridConvolve:
    """Reference-compatible facade (GSVC_CPU / GSVC_GPU unified); GSVC
    returns a numpy array."""

    def __init__(self, PixA_obj, AllocatedL, KerStack, nan_fill_value=0.0,
                 use_fft=False, normalize_kernel=True, device=None):
        self.PixA_obj = PixA_obj
        self.AllocatedL = AllocatedL
        self.KerStack = KerStack
        self.nan_fill_value = nan_fill_value
        self.use_fft = use_fft
        self.normalize_kernel = normalize_kernel
        self.device = device

    def GSVC(self, TiHW: Optional[int] = None) -> np.ndarray:
        if TiHW is not None:
            out = grid_convolve_uniform(
                self.PixA_obj, self.KerStack, TiHW,
                self.nan_fill_value, self.normalize_kernel, device=self.device,
            )
        else:
            out = grid_convolve_labels(
                self.PixA_obj, self.AllocatedL, self.KerStack,
                self.nan_fill_value, self.normalize_kernel, self.use_fft, device=self.device,
            )
        return out.cpu().numpy()
