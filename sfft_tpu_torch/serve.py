"""Resident engine server: one process holds the card, many pipeline
processes send it subtractions (counterpart of sfft_tpu/serve.py).

A fresh process pays for its CUDA context, the load of the kernel library
(built by nvcc on its first use), cuFFT plans and the static tables before
its first difference. The daemon pays once and serves solve+subtract
requests over a unix-domain socket.

Split of responsibilities:
  * `EngineServer` / `python -m sfft_tpu_torch.serve SOCKET [--device cpu]`
    — the daemon. Runs on the CUDA card unless device="cpu" is given
    (without a card it raises); a boot thread creates the CUDA context and
    loads the kernel library while the socket already answers.
  * `EngineClient` — stdlib + numpy; arrays travel as numpy and every torch
    operation happens inside the server, so a client never initialises
    CUDA. (Building a request's SFFTConfig imports sfft_tpu_torch, which
    imports torch but touches no device.)
  * `ensure_server()` — connect-or-spawn helper for pipelines.

Wire protocol (sfft_tpu's): 8-byte big-endian length + pickle (protocol 5)
per message, one request/response pair at a time per connection. The socket
is chmod 0600 and unix-domain, so only the owning user can connect —
required, since unpickling is code execution. Requests:

  {"op": "ping"}                       -> {"ok", "warm", "platform",
                                           "device", "attach_s", "pid"}
  {"op": "warm", "config": SFFTConfig} -> {"ok", "seconds"}
  {"op": "subtract", "config": cfg, "I":, "J":, "mI":, "mJ":,
   "solution": optional, "contam_mask": optional, "diff_dtype": optional}
      -> {"ok", "solution", "diff", "contam", "seconds"}
  {"op": "shutdown"}                   -> {"ok"}   (server exits)

`subtract` semantics mirror GeneralSFFT.GSS (solve on the masked pair, apply
to the unmasked; reference sfft/sfftcore/SFFTSubtract.py:839-923): omit
mI/mJ for the masked==unmasked fused path; pass `solution` to skip the solve
and only apply (the reference's SFFTSolution resume path,
sfft/sfftcore/SFFTSubtract.py:189-193). Images may be float32 or float64.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import subprocess
import sys
import threading
import time
import traceback
from typing import Optional

import numpy as np

# the port's own socket, so that sfft_tpu's daemon (/tmp/sfft_engine.sock)
# can live beside it
DEFAULT_SOCKET = os.path.join(os.environ.get("TMPDIR") or "/tmp", "sfft_torch_engine.sock")
_LEN = struct.Struct(">Q")
_MAX_MSG = 1 << 34  # 16 GB frame cap: corrupt-length guard, not a real limit


# ---------------------------------------------------------------- framing
def _send_msg(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=5)
    sock.sendall(_LEN.pack(len(payload)))
    sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            return None  # peer closed
        got += r
    return bytes(buf)


def _recv_msg(sock: socket.socket):
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > _MAX_MSG:
        raise ValueError(f"frame length {n} exceeds cap {_MAX_MSG}")
    payload = _recv_exact(sock, n)
    if payload is None:
        raise ConnectionError("peer closed mid-frame")
    return pickle.loads(payload)


def _wire(a):
    """An image for the wire, in its own layout when it is C- or
    F-contiguous (pickle keeps either): the engine's kernels take different
    routes on transposed and row-major planes, and a server result is held
    bit for bit to an in-process call on the same arrays."""
    if a is None:
        return None
    a = np.asarray(a)
    return a if a.flags.c_contiguous or a.flags.f_contiguous else np.ascontiguousarray(a)


def _host(a):
    """A received image as a writeable array in the layout it was sent in."""
    if a is None:
        return None
    a = np.asarray(a)
    return a if a.flags.writeable else np.array(a, order="K")


# ---------------------------------------------------------------- server
class EngineServer:
    """Single-card resident engine. Thread-per-connection accept loop with
    one compute lock (one compute thread per card: the kernel wrappers'
    launch counters and the static-table caches are shared); `ping` answers
    without taking the lock, so liveness checks never block behind a
    solve."""

    def __init__(self, socket_path: str = DEFAULT_SOCKET, device=None):
        import torch

        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "the engine server runs on the CUDA card unless device='cpu' is "
                    "given, and no CUDA device is available")
            device = "cuda"
        self.device = torch.device(device)
        self.socket_path = socket_path
        self._compute_lock = threading.Lock()
        self._shutdown = threading.Event()
        self._device_name: Optional[str] = None
        self._attach_s: Optional[float] = None

    # -- boot ------------------------------------------------------------
    def _boot_backend(self) -> None:
        """Create the CUDA context and load the kernel library (built on its
        first use) off the accept loop, so that ping answers meanwhile."""
        import torch

        t0 = time.time()

        def boot():
            try:
                if self.device.type == "cuda":
                    from sfft_tpu_torch import _kernels

                    torch.zeros(1, device=self.device)
                    self._device_name = torch.cuda.get_device_name(self.device)
                    _kernels.lib()
                else:
                    self._device_name = "cpu"
            except Exception:  # noqa: BLE001 - ping reports it as not warm
                traceback.print_exc()
                return
            self._attach_s = time.time() - t0

        threading.Thread(target=boot, name="sfft-serve-boot", daemon=True).start()

    # -- request handlers --------------------------------------------------
    def _handle(self, req: dict) -> dict:
        op = req.get("op")
        if op == "ping":
            return {
                "ok": True,
                "warm": self._attach_s is not None,
                "platform": self.device.type,
                "device": self._device_name,
                "attach_s": self._attach_s,
                "pid": os.getpid(),
            }
        if op == "shutdown":
            self._shutdown.set()
            return {"ok": True}
        if op == "warm":
            return self._op_warm(req)
        if op == "subtract":
            return self._op_subtract(req)
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _op_warm(self, req: dict) -> dict:
        """One step of the config on a seeded noise pair, then a sync: the
        static tables, FFT plans and kernel loads of the config are then
        made. (sfft_tpu warms on zeros; torch's solvers refuse the singular
        system that zeros give, where JAX's return NaN.)"""
        import torch

        from sfft_tpu_torch.config import torch_dtype
        from sfft_tpu_torch.core.engine import solve_and_subtract_same_fn

        cfg = req["config"]
        cfg.validate()
        t0 = time.time()
        with self._compute_lock:
            gen = torch.Generator(self.device).manual_seed(0)
            z = torch.randn((cfg.N0, cfg.N1), generator=gen, device=self.device,
                            dtype=torch_dtype(cfg.dtype))
            solve_and_subtract_same_fn(cfg)(z, z)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return {"ok": True, "seconds": time.time() - t0}

    def _op_subtract(self, req: dict) -> dict:
        from sfft_tpu_torch.config import torch_dtype
        from sfft_tpu_torch.core.engine import ElementalSFFT, GeneralSFFT

        cfg = req["config"]
        cfg.validate()
        I = _host(req["I"])
        J = _host(req["J"])
        mI = _host(req.get("mI"))
        mJ = _host(req.get("mJ"))
        if (mI is None) != (mJ is None):
            return {"ok": False,
                    "error": "provide both mI and mJ, or neither"}
        solution = req.get("solution")
        contam = _host(req.get("contam_mask"))
        diff_dtype = req.get("diff_dtype")  # None => cfg dtype

        t0 = time.time()
        with self._compute_lock:
            dev = self.device
            if solution is not None:
                # apply-only resume path (reference SFFTSolution argument)
                sol, diff = ElementalSFFT.ESS(
                    I, J, cfg, SFFTSolution=np.asarray(solution), Subtract=True, device=dev)
                contam_out = None
            elif mI is None:
                sol, diff, contam_out = GeneralSFFT.GSS(
                    I, J, I, J, cfg, ContamMask_I=contam, device=dev)
            else:
                sol, diff, contam_out = GeneralSFFT.GSS(
                    I, J, mI, mJ, cfg, ContamMask_I=contam, device=dev)
            # the cast on the device halves the copy of an f32 difference
            if diff_dtype is not None:
                diff = diff.to(torch_dtype(diff_dtype))
            sol_np = sol.cpu().numpy()
            diff_np = diff.cpu().numpy()
            contam_np = None if contam_out is None else contam_out.cpu().numpy()
        return {
            "ok": True,
            "solution": sol_np,
            "diff": diff_np,
            "contam": contam_np,
            "seconds": time.time() - t0,
        }

    # -- connection loop ---------------------------------------------------
    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._shutdown.is_set():
                try:
                    req = _recv_msg(conn)
                except (ConnectionError, ValueError, OSError):
                    break
                if req is None:
                    break
                try:
                    resp = self._handle(req)
                except Exception as exc:  # noqa: BLE001 - shipped to client
                    resp = {
                        "ok": False,
                        "error": f"{type(exc).__name__}: {exc}",
                        "traceback": traceback.format_exc(),
                    }
                try:
                    _send_msg(conn, resp)
                except OSError:
                    break
                if self._shutdown.is_set():
                    break
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def serve_forever(self) -> None:
        self._boot_backend()
        path = self.socket_path
        # refuse to clobber a LIVE server; replace only a stale socket file
        if os.path.exists(path):
            if _ping_path(path, timeout=2.0) is not None:
                raise RuntimeError(f"engine server already live on {path}")
            os.unlink(path)
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            srv.bind(path)
            os.chmod(path, 0o600)  # unpickling is code execution: owner-only
            srv.listen(8)
            srv.settimeout(0.5)  # poll the shutdown flag
            while not self._shutdown.is_set():
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                threading.Thread(
                    target=self._serve_conn, args=(conn,),
                    name="sfft-serve-conn", daemon=True).start()
        finally:
            srv.close()
            try:
                os.unlink(path)
            except OSError:
                pass


# ---------------------------------------------------------------- client
def _ping_path(path: str, timeout: float = 5.0) -> Optional[dict]:
    """One-shot ping; None if the socket is absent/dead/not a server."""
    try:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        s.connect(path)
        try:
            _send_msg(s, {"op": "ping"})
            resp = _recv_msg(s)
        finally:
            s.close()
        return resp if isinstance(resp, dict) and resp.get("ok") else None
    except (OSError, pickle.UnpicklingError, EOFError):
        return None


class EngineClient:
    """Client handle. Stdlib + numpy — using it never initialises CUDA in
    the client process."""

    def __init__(self, socket_path: str = DEFAULT_SOCKET,
                 timeout: Optional[float] = None):
        self.socket_path = socket_path
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        if timeout is not None:
            self._sock.settimeout(timeout)
        self._sock.connect(socket_path)
        self._lock = threading.Lock()

    # context manager
    def __enter__(self) -> "EngineClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def _rpc(self, req: dict) -> dict:
        with self._lock:
            _send_msg(self._sock, req)
            resp = _recv_msg(self._sock)
        if resp is None:
            raise ConnectionError("server closed the connection")
        return resp

    def ping(self) -> dict:
        return self._rpc({"op": "ping"})

    def warm(self, cfg) -> float:
        """Run one step of `cfg` on the server; returns server wall seconds.
        Call ahead of time so `subtract` finds its tables and plans made."""
        resp = self._rpc({"op": "warm", "config": cfg})
        _raise_on_error(resp)
        return resp["seconds"]

    def subtract(self, I, J, cfg, mI=None, mJ=None, solution=None,
                 contam_mask=None, diff_dtype=None):
        """GeneralSFFT.GSS over the wire. Returns (solution, diff, contam)
        as numpy. Omit mI/mJ for masked==unmasked (fused single pass); pass
        `solution` to skip the solve and only apply; `diff_dtype='float32'`
        halves the device-to-host and wire bytes of the difference."""
        resp = self._rpc({
            "op": "subtract",
            "config": cfg,
            "I": _wire(I),
            "J": _wire(J),
            "mI": _wire(mI),
            "mJ": _wire(mJ),
            "solution": None if solution is None else np.asarray(solution),
            "contam_mask": _wire(contam_mask),
            "diff_dtype": diff_dtype,
        })
        _raise_on_error(resp)
        return resp["solution"], resp["diff"], resp["contam"]

    def shutdown(self) -> None:
        try:
            self._rpc({"op": "shutdown"})
        except (ConnectionError, OSError):
            pass  # server may exit before the response lands


class EngineServerError(RuntimeError):
    """Server-side failure, message + remote traceback attached."""

    def __init__(self, message: str, remote_traceback: Optional[str] = None):
        super().__init__(message)
        self.remote_traceback = remote_traceback


def _raise_on_error(resp: dict) -> None:
    if not resp.get("ok"):
        raise EngineServerError(
            resp.get("error", "engine server error"),
            resp.get("traceback"))


def ensure_server(socket_path: str = DEFAULT_SOCKET,
                  spawn_timeout: float = 120.0,
                  env: Optional[dict] = None,
                  device: Optional[str] = None) -> dict:
    """Connect to a live server at `socket_path`, or spawn one (detached
    daemon subprocess, on the card, or on `device`) and wait for it to
    answer ping. Returns the ping response. The spawned server keeps
    running after the caller exits — that is the point: the NEXT job finds
    the context, library and caches made. It loads the kernel library that
    exists for the checkout's sources; it builds one only if none does."""
    resp = _ping_path(socket_path)
    if resp is not None:
        return resp
    proc_env = dict(os.environ if env is None else env)
    # make the package importable in the child regardless of its cwd
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prev = proc_env.get("PYTHONPATH", "")
    if pkg_root not in prev.split(os.pathsep):
        proc_env["PYTHONPATH"] = (
            pkg_root + (os.pathsep + prev if prev else ""))
    subprocess.Popen(
        [sys.executable, "-m", "sfft_tpu_torch.serve", socket_path,
         *(["--device", device] if device is not None else [])],
        env=proc_env,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
        start_new_session=True,  # survive the parent's exit
    )
    deadline = time.time() + spawn_timeout
    while time.time() < deadline:
        resp = _ping_path(socket_path, timeout=2.0)
        if resp is not None:
            return resp
        time.sleep(0.25)
    raise TimeoutError(
        f"engine server did not come up on {socket_path} "
        f"within {spawn_timeout:.0f}s")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m sfft_tpu_torch.serve",
                                 description="sfft_tpu_torch resident engine server")
    ap.add_argument("socket", nargs="?", default=DEFAULT_SOCKET)
    ap.add_argument("--device", default=None,
                    help="'cpu' to serve on the CPU (default: the CUDA card)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    print(f"sfft_tpu_torch engine server on {args.socket} (pid {os.getpid()})", flush=True)
    EngineServer(args.socket, device=args.device).serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
