"""Kill + resume parity of the port's outer loop, the checkpoint fields, and
the checkpoint writer thread (mirrors of tests/test_resume.py at its sizes,
on the CPU, plus the writer's failure modes)."""

import threading

import numpy as np
import pytest
import torch

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.io.mat import (
    load_checkpoint,
    save_checkpoint,
)
from nlos_surface_optimization_torch.optim import outer_loop
from nlos_surface_optimization_torch.optim.outer_loop import (
    CheckpointWriter,
    InverseRenderingLoop,
    LoopConfig,
)

torch.set_num_threads(1)

KEY = pt.key(23)


def _grid_mesh(n, zfn, extent=0.28):
    xs = np.linspace(-extent, extent, n)
    gx, gy = np.meshgrid(xs, xs)
    z = zfn(gx, gy)
    v = np.stack([gx.ravel(), gy.ravel(), z.ravel()], 1).astype(np.float32)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces.append([a, a + n, a + 1])
            faces.append([a + n, a + n + 1, a + 1])
    return v, np.array(faces, np.int32)


def _build_loop(gt, lighting, lnormal, cfg, v0, f0, gt_mesh, ckpt_dir):
    lcfg = LoopConfig(scan_resolution=8, loss_epsilon=5e-3,
                      forced_remesh_every=5, checkpoint_dir=ckpt_dir)
    return InverseRenderingLoop(gt, lighting, lnormal, cfg, lcfg, v0, f0,
                                KEY, gt_mesh=gt_mesh, log=lambda s: None,
                                device="cpu")


def test_resume_matches_uninterrupted(tmp_path):
    v_gt, f_gt = _grid_mesh(8, lambda x, y: 0.5 + 0.04 * np.sin(6 * x))
    gt_mesh = pt.make_mesh(v_gt, f_gt, device="cpu", dtype=np.float64)
    cfg = pt.RenderConfig(num_samples=2000, num_bins=220,
                          distance_resolution=6e-3)
    lighting, lnormal = pt.make_confocal_scan(8)
    gt, _ = pt.render_transient(pt.make_mesh(v_gt, f_gt, device="cpu"),
                                lighting, lnormal, cfg, pt.key(99))
    gt = gt.numpy()
    v0, f0 = _grid_mesh(8, lambda x, y: 0.5 + 0.0 * x)

    # Uninterrupted run: 12 iterations (crosses the forced remesh at 5).
    full = _build_loop(gt, lighting, lnormal, cfg, v0, f0, gt_mesh,
                       str(tmp_path / "full"))
    full.run(max_iters=12)

    # Resume from the iteration-6 checkpoint and continue to 12.
    ckpt = tmp_path / "full" / "00006.mat"
    assert ckpt.exists()
    lcfg = LoopConfig(scan_resolution=8, loss_epsilon=5e-3,
                      forced_remesh_every=5,
                      checkpoint_dir=str(tmp_path / "res"))
    res = InverseRenderingLoop.from_checkpoint(
        str(ckpt), gt, lighting, lnormal, cfg, lcfg, gt_mesh=gt_mesh,
        log=lambda s: None, device="cpu")
    assert res.state.t == 6
    res.run(max_iters=12)

    for k in ("l2", "l2_original", "v2"):
        a = np.asarray(full.history[k], np.float64)
        b = np.asarray(res.history[k], np.float64)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(res.state.v, full.state.v, rtol=1e-4,
                               atol=1e-7)
    assert np.array_equal(res.state.f, full.state.f)
    assert res.state.testing_flag == full.state.testing_flag
    assert res.state.run_count == full.state.run_count
    np.testing.assert_allclose(res.state.smooth_weight,
                               full.state.smooth_weight, rtol=1e-6)
    assert any(r["kind"] == "remesh" for r in full.stats)


def test_checkpoint_roundtrip_fields(tmp_path):
    """Every LoopState scalar survives save_checkpoint/load_checkpoint."""
    v = np.zeros((4, 3), np.float32)
    f = np.asarray([[0, 1, 2], [1, 3, 2]], np.int32)
    snap = {"old_v": v + 1, "run_count": 3, "weight_flag": 1,
            "testing_flag": 0, "smooth_weight": 2.5e-3, "lr": 1.1e-4,
            "loss_epsilon": 5e-5, "scan_resolution": 96.0,
            "sample_num": 30000.0, "smooth_ratio": 12.5,
            "l2_first": 0.125}
    p = str(tmp_path / "ck.mat")
    save_checkpoint(p, v=v, f=f, iteration=7, rng_key=KEY.numpy(),
                    opt_m=v, opt_v=v, opt_step=7, loop_state=snap,
                    history={"l2": [1.0, 0.5], "l2_original": [1.1, 0.6],
                             "v2": [0.01, 0.009]})
    d = load_checkpoint(p)
    for k, val in snap.items():
        got = np.asarray(d["ls_" + k])
        np.testing.assert_allclose(got.ravel(),
                                   np.asarray(val, np.float64).ravel())
    assert list(np.asarray(d["hist_l2"]).ravel()) == [1.0, 0.5]
    np.testing.assert_array_equal(np.asarray(d["rng_key"]).ravel(),
                                  KEY.numpy())


def _in_thread(fn, seconds=20.0):
    """Run fn on a thread and fail (rather than hang) if it blocks."""
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), "the checkpoint writer blocked"


@pytest.mark.parametrize("error", [KeyboardInterrupt, SystemExit])
def test_writer_survives_a_dying_worker(monkeypatch, error):
    """A BaseException kills the worker: it marks the writer broken, and
    the write it was on, the queued ones and every later one are written
    on the caller's thread, in order, without blocking on the queue."""
    written, logs = [], []
    gate = threading.Event()

    def save(path, **kw):
        if path == "ck0" and not written:
            gate.wait(10)          # let the queue fill behind this write
            written.append("died")
            raise error()
        written.append(path)

    monkeypatch.setattr(outer_loop, "save_checkpoint", save)
    w = CheckpointWriter(logs.append, depth=2)

    def puts():
        for i in range(3):         # one in flight, two waiting
            w.put(f"ck{i}", {})
        gate.set()
        for i in range(3, 6):      # the worker dies meanwhile
            w.put(f"ck{i}", {})
        w.flush()

    _in_thread(puts)
    assert w.broken
    assert written == ["died"] + [f"ck{i}" for i in range(6)]
    assert any("synchronously" in m for m in logs)


def test_writer_logs_an_io_error_and_goes_on(monkeypatch):
    written, logs = [], []

    def save(path, **kw):
        if path == "bad":
            raise OSError("disk full")
        written.append(path)

    monkeypatch.setattr(outer_loop, "save_checkpoint", save)
    w = CheckpointWriter(logs.append)

    def puts():
        for p in ("a", "bad", "b"):
            w.put(p, {})
        w.flush()

    _in_thread(puts)
    assert not w.broken
    assert written == ["a", "b"]
    assert any("disk full" in m for m in logs)


def _tiny_loop(tmp_path, **kw):
    v, f = _grid_mesh(4, lambda x, y: 0.5 + 0.0 * x)
    lighting, lnormal = pt.make_confocal_scan(2)
    cfg = pt.RenderConfig(num_samples=200, num_bins=100,
                          distance_resolution=6e-3)
    gt = np.random.RandomState(0).rand(4, 100).astype(np.float32) * 1e-3
    lcfg = LoopConfig(scan_resolution=4, checkpoint_dir=str(tmp_path))
    loop = InverseRenderingLoop(gt, lighting, lnormal, cfg, lcfg, v, f, KEY,
                                log=lambda s: None, device="cpu", **kw)
    return loop, (gt, lighting, lnormal, cfg, lcfg)


def test_restored_arrays_are_row_major(tmp_path):
    """loadmat returns column-major arrays; the restored loop holds them
    row-major as a fresh loop does (on the card the rounding of a reduction
    follows the layout, so a column-major Adam moment made a resumed run
    differ from the uninterrupted one in the last bit)."""
    loop, args = _tiny_loop(tmp_path)
    loop.run(max_iters=2)
    res = InverseRenderingLoop.from_checkpoint(
        str(tmp_path / "00001.mat"), *args, log=lambda s: None, device="cpu")
    for a in (res.state.v, res.state.f, res.state.old_v):
        assert a.flags.c_contiguous
    for t in (res.opt_state.m, res.opt_state.v, res.gt, res.lighting):
        assert t.is_contiguous()
    np.testing.assert_array_equal(
        res.state.v, load_checkpoint(str(tmp_path / "00001.mat"))["v"])


def test_loop_flushes_checkpoints_when_a_step_raises(tmp_path, monkeypatch):
    """run() flushes the queued checkpoints in ``finally``."""
    loop, _ = _tiny_loop(tmp_path)
    step = loop.step

    def step_then_fail():
        if loop.state.t == 2:
            raise RuntimeError("stop")
        return step()

    monkeypatch.setattr(loop, "step", step_then_fail)
    with pytest.raises(RuntimeError):
        loop.run(max_iters=5)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["00000.mat",
                                                          "00001.mat"]
    assert int(np.asarray(load_checkpoint(
        str(tmp_path / "00001.mat"))["iteration"]).ravel()[0]) == 1
