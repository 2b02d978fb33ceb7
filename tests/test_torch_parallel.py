"""The survey layer of sfft_tpu_torch (utils/multiproc.py,
parallel/batch.py, parallel/scheduler.py) against sfft_tpu's on the CPU.

- The scheduler with the fake prep and subtract functions of
  tests/test_parallel.py: both packages run the same fakes, and their status
  dicts, results and event orders are compared (failures, timeouts,
  prefetch, MESP's overlap of prep and subtraction, streaming groups and
  the two-deep pipeline of run_mesh_batched). The port's grouping runs on
  devices=["cpu", "cpu"], sfft_tpu's on a 2-device CPU mesh.
- batched_subtract on three pairs against sfft_tpu's on the CPU mesh:
  solutions to rtol 1e-6, differences to 1e-8 max|J|
  (tests/test_engine.py:56-58), and bit for bit against the port's
  single GSS calls; the default trio runs them as one batched step
  (counted).
- A real MESP (both dispatch modes) on two small pairs and one broken pair
  made from the golden sparse FITS, bit for bit against the port's single
  ESP calls (no sfft_tpu packet runs here).
"""

import threading
import time

import numpy as np
import pytest
import torch

import sfft_tpu  # noqa: F401  (x64)
import jax.numpy as jnp
from sfft_tpu.api.easy_sparse import EasySparsePacket as JESP
from sfft_tpu.parallel import batch as jbatch
from sfft_tpu.parallel import scheduler as jsched
from sfft_tpu.utils import multiproc as jmp

from sfft_tpu_torch.api.easy_sparse import EasySparsePacket
from sfft_tpu_torch.core.engine import GeneralSFFT, solve_and_subtract_batched_fn
from sfft_tpu_torch.io import fits
from sfft_tpu_torch.parallel import batch as tbatch
from sfft_tpu_torch.parallel import scheduler as tsched
from sfft_tpu_torch.utils import multiproc as tmp

from test_torch_easy import DATA
from test_torch_engine import cfgs, make_pair

torch.set_num_threads(2)

CPU2 = ["cpu", "cpu"]


def test_multiproc_matches_reference():
    for mod in (jmp, tmp):
        out = mod.MultiProc.MP(list(range(20)), lambda t: t * t, nproc=4, mode="threading")
        assert out == {t: t * t for t in range(20)}
    with pytest.raises(tmp.TimeoutError_):
        with tmp.TimeoutAfter(0.2):
            t0 = time.time()
            while time.time() - t0 < 5:
                sum(range(1000))


def _both(run, devices=CPU2):
    """run(scheduler module, extra keyword arguments) for sfft_tpu's module
    and the port's (on CPU workers)."""
    return run(jsched, {}), run(tsched, {"devices": devices})


def test_scheduler_status_and_failures_match_reference():
    def prep_fn(tid):
        if tid == 2:
            raise RuntimeError("prep boom")
        return {"data": tid * 10}

    def subtract_fn(tid, prep):
        if tid == 3:
            raise RuntimeError("sub boom")
        return prep["data"] + 1

    def run(mod, kw):
        status, products = mod.MultiTaskScheduler(
            5, prep_fn, subtract_fn, NUM_THREADS_4PREPROC=2, NUM_THREADS_4SUBTRACT=2,
            VERBOSE_LEVEL=0, **kw).run()
        return status, {t: p.get("result") for t, p in products.items()}

    ref, port = _both(run)
    assert port == ref
    assert port[0] == {0: 2, 1: 2, 2: -1, 3: -2, 4: 2}
    assert port[1] == {0: 1, 1: 11, 2: None, 3: None, 4: 41}


def test_scheduler_timeout_matches_reference():
    def subtract_fn(tid, prep):
        if tid == 0:
            t0 = time.time()
            while time.time() - t0 < 10:  # interruptible busy loop
                sum(range(1000))
        return "done"

    def run(mod, kw):
        t0 = time.time()
        status, _ = mod.MultiTaskScheduler(
            2, lambda tid: tid, subtract_fn, NUM_THREADS_4PREPROC=1, NUM_THREADS_4SUBTRACT=1,
            TIMEOUT_4SUBTRACT_EACHTASK=0.5, VERBOSE_LEVEL=0, **kw).run()
        assert time.time() - t0 < 8
        return status

    ref, port = _both(run, ["cpu"])
    assert port == ref == {0: -2, 1: 2}


def test_scheduler_prefetch_matches_reference():
    """tests/test_parallel.py::test_scheduler_prefetch_overlaps_next_task on
    both packages: every task but the first claimed is prefetched before its
    subtraction, and a prefetch is issued before the first subtraction
    ends."""

    def run(mod, kw):
        events, lock = [], threading.Lock()

        def prefetch_fn(prep):
            with lock:
                events.append(("prefetch", prep["tid"]))
            return dict(prep, dev=True)

        def subtract_fn(tid, prep):
            with lock:
                events.append(("sub_start", tid, prep["dev"]))
            time.sleep(0.05)
            with lock:
                events.append(("sub_end", tid))
            return prep["dev"]

        sched = mod.MultiTaskScheduler(
            4, lambda tid: {"tid": tid, "dev": False}, subtract_fn, NUM_THREADS_4PREPROC=4,
            NUM_THREADS_4SUBTRACT=1, VERBOSE_LEVEL=0, prefetch_fn=prefetch_fn, **kw)
        sched.run_prep_only()
        status, products = sched.run()
        pf = {e[1] for e in events if e[0] == "prefetch"}
        for e in events:
            if e[0] == "sub_start" and e[1] in pf:
                assert e[2] is True
        first_end = next(i for i, e in enumerate(events) if e[0] == "sub_end")
        assert any(e[0] == "prefetch" for e in events[:first_end])
        return status, len(pf), sorted(products[t]["result"] for t in range(4))

    ref, port = _both(run, ["cpu"])
    assert port == ref
    assert port[1] == 3 and port[2] == [False, True, True, True]


@pytest.mark.parametrize("mesh_batch", [False, True])
def test_mesp_prep_overlaps_subtract_matches_reference(monkeypatch, mesh_batch):
    """MESP runs the prep in the prep stage, so the subtraction of task 0
    starts while task 1's prep runs (tests/test_parallel.py
    test_mesp_prep_overlaps_subtract), with the packets' stages replaced by
    fakes in both packages; the port's device keyword reaches the
    subtraction only."""

    def run(packet, multi, kw):
        events, seen = [], []

        def fake_prep(FITS_REF, FITS_SCI, **k):
            seen.append(("prep", sorted(k)))
            tid = int(FITS_REF[-6])
            events.append(("prep_start", tid, time.time()))
            time.sleep(0.3 if tid == 1 else 0.05)
            events.append(("prep_end", tid, time.time()))
            return {"tid": tid, "cfg": "cfg0", "PixA_I": np.zeros((4, 4)), "PixA_J": 1,
                    "PixA_mI": 2, "PixA_mJ": 3, "ContamMask_I": 0}

        def fake_subtract(prep, FITS_REF, **k):
            seen.append(("sub", k.get("device")))
            events.append(("sub_start", prep["tid"], time.time()))
            time.sleep(0.1)
            events.append(("sub_end", prep["tid"], time.time()))
            return prep["tid"]

        monkeypatch.setattr(packet, "ESP_Prep", staticmethod(fake_prep))
        monkeypatch.setattr(packet, "ESP_Subtract", staticmethod(fake_subtract))
        mesp = multi([f"/fake/ref{t}.fits" for t in range(2)],
                     [f"/fake/sci{t}.fits" for t in range(2)], **kw)
        status, products = mesp.MESP(NUM_THREADS_4PREPROC=2, NUM_THREADS_4SUBTRACT=1,
                                     MESH_BATCH=mesh_batch, VERBOSE_LEVEL=0)
        t = {(kind, tid): tt for kind, tid, tt in events}
        if not mesh_batch:
            assert t[("sub_start", 0)] < t[("prep_end", 1)]
        return status, [products[i]["result"] for i in range(2)], seen

    ref = run(JESP, jsched.MultiEasySparsePacket, {})
    port = run(EasySparsePacket, tsched.MultiEasySparsePacket, {"device": "cpu"})
    assert port[:2] == ref[:2] == ({0: 2, 1: 2}, [0, 1])
    preps = [k for what, k in port[2] if what == "prep"]
    assert preps and all("device" not in k and "plain" not in k for k in preps)
    assert {d for what, d in port[2] if what == "sub"} == {torch.device("cpu")}


def _fake_batched(events):
    def fake(I, J, mI, mJ, cfg, where, plain=False):
        B = len(I)
        events.append(("launch", B, time.time()))
        time.sleep(0.05)
        return (torch.zeros(B, 3), torch.zeros(B, 4, 4), torch.zeros(B)) if isinstance(
            I, list) else (np.zeros((B, 3)), np.zeros((B, 4, 4)), np.zeros(B))
    return fake


def test_mesh_batch_streams_groups_matches_reference(monkeypatch):
    """With one prep thread and two devices, the first full group is
    dispatched before the slow prep of task 4 ends; 5 tasks make groups of 2,
    2 and a singleton (tests/test_parallel.py test_mesh_batch_streams_groups)."""
    arr = np.zeros((4, 4))

    def run(mod, bmod, where):
        events = []

        def prep_fn(tid):
            time.sleep(0.5 if tid == 4 else 0.05)
            events.append(("prep_end", tid, time.time()))
            return {"tid": tid}

        monkeypatch.setattr(bmod, "batched_subtract", _fake_batched(events))
        status, products = mod.run_mesh_batched(
            5, prep_fn, lambda tid, prep, precomputed=None: (tid, precomputed is None),
            lambda prep: ("cfg0", arr, arr, arr, arr, True),
            NUM_THREADS_4PREPROC=1, VERBOSE_LEVEL=0, **where)
        t = {(k, i): tt for k, i, tt in events if k == "prep_end"}
        launches = [(n, tt) for k, n, tt in events if k == "launch"]
        assert launches[0][1] < t[("prep_end", 4)]
        return status, [products[i]["result"] for i in range(5)], [n for n, _ in launches]

    ref = run(jsched, jbatch, {"mesh": jbatch.make_data_mesh(2)})
    port = run(tsched, tbatch, {"devices": CPU2})
    assert port == ref
    assert port[0] == dict.fromkeys(range(5), 2)
    assert port[1] == [(t, t == 4) for t in range(5)] and port[2] == [2, 2]


def test_mesh_batch_pipelines_collect_behind_next_group_matches_reference(monkeypatch):
    """Group k+1's upload and dispatch are issued before group k's results
    are collected (tests/test_parallel.py
    test_mesh_batch_pipelines_collect_behind_next_group)."""
    arr = np.zeros((4, 4))

    def run(mod, bmod, where):
        events = []

        def fake_stage(stacks, target):
            events.append(("stage", len(stacks[0])))
            return stacks

        def fake_batched(*args, **kw):
            events.append(("launch", sum(e[0] == "launch" for e in events) + 1))
            return _fake_batched([])(*args, **kw)

        def subtract_fn(tid, prep, precomputed=None):
            events.append(("finish", tid))
            assert precomputed is not None
            return tid

        monkeypatch.setattr(mod, "_stage_group_arrays", fake_stage)
        monkeypatch.setattr(bmod, "batched_subtract", fake_batched)
        status, products = mod.run_mesh_batched(
            4, lambda tid: {"tid": tid}, subtract_fn,
            lambda prep: ("cfg0", arr, arr, arr, arr, True),
            NUM_THREADS_4PREPROC=4, VERBOSE_LEVEL=0, **where)
        order = {e: i for i, e in enumerate(events) if e[0] != "stage"}
        first_finish = min(i for e, i in order.items() if e[0] == "finish")
        assert order[("launch", 2)] < first_finish
        return (status, sorted(products[t]["result"] for t in range(4)),
                [e for e in events if e[0] == "stage"])

    ref = run(jsched, jbatch, {"mesh": jbatch.make_data_mesh(2)})
    port = run(tsched, tbatch, {"devices": CPU2})
    assert port == ref
    assert port[1] == [0, 1, 2, 3] and port[2] == [("stage", 2)] * 2


def test_without_a_card_nothing_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbatch.data_devices()
    with pytest.raises(RuntimeError, match="CUDA"):
        tsched.MultiTaskScheduler(1, lambda t: t, lambda t, p: p, VERBOSE_LEVEL=0).run()
    with pytest.raises(RuntimeError, match="CUDA"):
        tsched.MultiEasySparsePacket(["r"], ["s"]).MESP(VERBOSE_LEVEL=0)
    I, J = make_pair(3)
    _, tc = cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        tbatch.batched_subtract([I], [J], [I], [J], tc)
    with pytest.raises(ValueError, match="PACK_H2D"):
        tsched.MultiEasySparsePacket(["r"], ["s"], device="cpu").MESP(PACK_H2D="on")
    assert tbatch.data_devices(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2


def test_upload_planes_keeps_layouts_and_identity():
    rng = np.random.default_rng(4)
    a = np.asfortranarray(rng.normal(size=(6, 5)))
    b = rng.normal(size=(6, 5))
    b.flags.writeable = False
    planes, event = tbatch.upload_planes([a, b, a, torch.as_tensor(b.copy())], "cpu")
    assert event is None and planes[0] is planes[2]
    assert planes[0].stride() == (1, 6) and planes[1].stride() == (5, 1)
    assert np.array_equal(planes[0].numpy(), a) and np.array_equal(planes[1].numpy(), b)


def _stack_of_pairs():
    """Three 56 x 48 pairs (tests/test_engine.py's generator), the masked
    ones with a zeroed patch; the first pair's planes transposed in memory."""
    Is, Js, mIs, mJs = [], [], [], []
    for k in range(3):
        I, J = make_pair(30 + k, 56, 48)
        mI, mJ = I.copy(), J.copy()
        mI[10 + k:16 + k, 20:26] = 0.0
        mJ[10 + k:16 + k, 20:26] = 0.0
        Is.append(I), Js.append(J), mIs.append(mI), mJs.append(mJ)
    Is[0], mIs[0] = np.asfortranarray(Is[0]), np.asfortranarray(mIs[0])
    return Is, Js, mIs, mJs


def test_batched_subtract_matches_reference_and_single_calls():
    jc, tc = cfgs(N0=56, N1=48, w=2)
    stacks = _stack_of_pairs()
    # the default trio runs the device's pairs as one batched step
    steps = solve_and_subtract_batched_fn.steps
    sols, diffs, rms = tbatch.batched_subtract(*stacks, tc, devices=["cpu"])
    assert solve_and_subtract_batched_fn.steps == steps + 1
    jsols, jdiffs, jrms = jbatch.batched_subtract(
        *(jnp.asarray(np.stack(s)) for s in stacks), jc, jbatch.make_data_mesh(1))
    assert sols.shape == (3, tc.NEQ) and diffs.shape == (3, 56, 48) and rms.dtype == torch.float32
    jsols, jdiffs = np.asarray(jsols), np.asarray(jdiffs)
    for k in range(3):
        np.testing.assert_allclose(sols[k].numpy(), jsols[k], rtol=1e-6,
                                   atol=1e-7 * np.abs(jsols[k]).max())
        np.testing.assert_allclose(diffs[k].numpy(), jdiffs[k], rtol=0,
                                   atol=1e-8 * np.abs(stacks[1][k]).max())
        sol1, diff1, _ = GeneralSFFT.GSS(*(s[k] for s in stacks), tc, device="cpu")
        assert torch.equal(sols[k], sol1) and torch.equal(diffs[k], diff1)
        assert float(rms[k]) == float(torch.sqrt(torch.mean(diff1.float() ** 2)))
    np.testing.assert_allclose(rms.numpy(), np.asarray(jrms), rtol=1e-6)
    # a stacked array runs the same as a list of its planes
    st = tbatch.batched_subtract(*(np.stack(s[1:]) for s in stacks), tc, devices=["cpu"])
    assert torch.equal(st[0], sols[1:]) and torch.equal(st[1], diffs[1:])


@pytest.fixture(scope="module")
def survey_queue(tmp_path_factory):
    """Three tasks: the golden sparse pair, the same pair with seeded noise
    added to SCI, and a broken pair whose SCI has another shape."""
    d = tmp_path_factory.mktemp("survey")
    ref, sci = (f"{DATA}/golden_sparse_{s}.fits" for s in ("ref", "sci"))
    data, hdr = fits.read(sci)
    noisy = data + np.random.default_rng(11).normal(0, 0.5, data.shape).astype(data.dtype)
    fits.write(str(d / "noisy_sci.fits"), noisy, hdr)
    fits.write(str(d / "broken_sci.fits"), data[:-8], hdr)
    return d, [ref] * 3, [sci, str(d / "noisy_sci.fits"), str(d / "broken_sci.fits")]


_SINGLE = {}


def single_esp(d, ref, sci, t, kw):
    """The port's single ESP call of task t (its results and its difference
    FITS), computed once per module."""
    if t not in _SINGLE:
        path = str(d / f"single_{t}.fits")
        _SINGLE[t] = EasySparsePacket.ESP(ref, sci, FITS_DIFF=path, VERBOSE_LEVEL=0, **kw), path
    return _SINGLE[t]


@pytest.mark.parametrize("mesh_batch", [False, True])
def test_mesp_matches_single_esp_calls(survey_queue, mesh_batch):
    d, refs, scis = survey_queue
    kw = dict(KerHWLimit=(2, 6), PostAnomalyCheck=True, device="cpu")
    diffs = [str(d / f"mesp_{mesh_batch}_{t}.fits") for t in range(3)]
    mesp = tsched.MultiEasySparsePacket(refs, scis, FITS_DIFF_Queue=diffs, **kw)
    status, products = mesp.MESP(NUM_THREADS_4PREPROC=2, MESH_BATCH=mesh_batch,
                                 VERBOSE_LEVEL=0)
    assert status == {0: 2, 1: 2, 2: -1}
    for t in range(2):
        (sdiff, sprep, ssol, sfs, ssig), single = single_esp(d, refs[t], scis[t], t, kw)
        mdiff, mprep, msol, mfs, msig = products[t]["result"]
        assert np.array_equal(msol, ssol) and np.array_equal(mdiff, sdiff, equal_nan=True)
        assert (mfs, msig) == (sfs, ssig)
        assert np.array_equal(mprep["SExCatalog-SubSource"]["MASK_PostAnomaly"],
                              sprep["SExCatalog-SubSource"]["MASK_PostAnomaly"])
        (a, ha), (b, hb) = fits.read(diffs[t]), fits.read(single)
        assert np.array_equal(a, b, equal_nan=True) and list(ha.cards) == list(hb.cards)
