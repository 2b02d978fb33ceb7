"""Does a batched library call give each pair the bits of its single call?

Runs, on the CUDA card, the library calls a batched solve+subtract step
could make over a leading pair axis (cuBLAS products and solves, cuFFT
transforms, reductions, einsum) at the 4096^2 fast step's shapes, for
B = 2, 4, 8, and prints for each call whether every pair's slice of the
batched result equals the single call on that pair bit for bit. The
batched step of sfft_tpu_torch (core/engine.solve_and_subtract_batched_fn)
runs the calls printed False pair by pair. Imports torch only.

    python tools/batch_bits_probe.py
"""

import sys

import torch


def main():
    if not torch.cuda.is_available():
        print("batch_bits_probe: needs a CUDA device", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape, dt=torch.float64):
        return torch.randn(*shape, generator=gen, dtype=torch.float64).to(dt).to(dev)

    results = {}

    def check(name, single, batched, args):
        out = batched(*args)
        ok = True
        for b in range(args[0].shape[0]):
            one = single(*[t[b] for t in args])
            if isinstance(one, tuple):
                ok &= all(torch.equal(u, v[b]) for u, v in zip(one, out))
            else:
                ok &= torch.equal(one, out[b])
        results.setdefault(name, []).append((args[0].shape[0], ok))

    n, neq = 4096, 1740
    for B in (2, 4, 8):
        P, M = rand(B, 6, 5, 5), rand(B, 6, 5, 5)
        S0, S1 = rand(33, 5, 5), rand(33, 5, 5)
        check("einsum ast,rsu,etv,buv",
              lambda p, m: torch.einsum("ast,rsu,etv,buv->abre", p, S0, S1, m),
              lambda p, m: torch.einsum("zast,rsu,etv,zbuv->zabre", p, S0, S1, m), (P, M))
        K, P1 = rand(B, 7, n), rand(7, n)
        check("matmul, long contraction", lambda k: k @ P1.T, lambda k: k @ P1.T, (K,))
        rhs, inv = rand(B, 6), rand(6, 6)
        check("matvec 6 x 6", lambda r: inv @ r, lambda r: (inv @ r[:, :, None])[..., 0], (rhs,))
        X = rand(B, 7, n, n, dt=torch.float32)
        check("rfft2 f32", torch.fft.rfft2, torch.fft.rfft2, (X,))
        del X
        H = torch.fft.rfft2(rand(B, n, n))
        check("irfft2 c128", lambda h: torch.fft.irfft2(h, s=(n, n)),
              lambda h: torch.fft.irfft2(h, s=(n, n)), (H,))
        del H
        A = rand(B, neq, neq)
        A = A @ A.transpose(1, 2) + neq * torch.eye(neq, device=dev, dtype=torch.float64)
        b = rand(B, neq)
        check("lu_factor f32", torch.linalg.lu_factor, torch.linalg.lu_factor, (A.float(),))
        check("solve f64", torch.linalg.solve, torch.linalg.solve, (A, b))
        check("matvec NEQ", lambda a, v: a @ v, lambda a, v: (a @ v[:, :, None])[..., 0], (A, b))
        d = rand(B, n, n)
        check("mean of squares", lambda x: torch.mean(x.float() ** 2),
              lambda x: torch.mean(x.float() ** 2, dim=(1, 2)), (d,))
        del A, d
        torch.cuda.empty_cache()
    for name, rows in results.items():
        print(f"{name}: " + ", ".join(f"B={B} {'bit for bit' if ok else 'differs'}"
                                      for B, ok in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
