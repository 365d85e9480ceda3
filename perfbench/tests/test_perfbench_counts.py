"""The yardstick's arithmetic: the bottom kernel's bytes and operations
(K1 and K2), the SplitNN's FLOPs, and the readers' shares worked out
from a device trace, each against values worked by hand."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench.harness import flops, readers
from perfbench.harness.profile import DeviceTrace
from perfbench.rooflines import bottom_kernel

H100 = {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}


def test_k1_eval_block():
    """K1 at HI's evaluation block: x (3, 512, 11), w (3, 11, 8),
    b (3, 8), out (3, 512, 8), f32."""
    nbytes, ops = bottom_kernel.launch(m=3, rows=512, d=11, o=8,
                                       gather=False)
    assert nbytes == 4 * (16896 + 264 + 24 + 12288) == 117888
    assert ops == 2 * 3 * 512 * 11 * 8 + 3 * 512 * 8 == 282624
    bound = bottom_kernel.bound_seconds(3, 512, 11, 8, False, H100)
    assert bound == pytest.approx(117888 / 3.35e12)     # bytes bound it


def test_k2_training_step():
    """K2 at HI's training step: 700 gathered rows and their 700 int32
    indices."""
    nbytes, ops = bottom_kernel.launch(m=3, rows=700, d=11, o=8,
                                       gather=True)
    assert nbytes == 4 * (23100 + 264 + 24 + 16800) + 4 * 700 == 163552
    assert ops == 2 * 3 * 700 * 11 * 8 + 3 * 700 * 8 == 386400


def test_model_flops_hi_mlp():
    """HI × mlp, clients 11/11/10, o = 8, H = 64, one output: a row's
    bottoms 184 + 184 + 168 = 536, top 2·24·64 + 64 + 2·64 + 1 = 3,265."""
    assert flops.forward_flops("mlp", [11, 11, 10], 8, 64, 1) == 536 + 3265
    assert flops.train_flops("mlp", [11, 11, 10], 8, 64, 1) == (
        2 * 536 + 3 * 3265)


def test_model_flops_yp_linreg():
    """YP × linreg, 3 × 30 columns, o = 1: 3 · (2·30 + 1) = 183 a row."""
    assert flops.forward_flops("linreg", [30, 30, 30], 1, 64, 1) == 183
    assert flops.train_flops("linreg", [30, 30, 30], 1, 64, 1) == 366


def _trace():
    """A 10 ms window with two kernels and a copy: busy 0–1, 2–4 (two
    overlapping ops) and 6–7 ms."""
    ops = [("void bottom_kernel<8>", 0.000, 0.001),
           ("void bottom_kernel<8>", 0.002, 0.003),
           ("Memcpy DtoH", 0.0025, 0.004),
           ("elementwise", 0.006, 0.007)]
    return DeviceTrace(ops=ops, t0=0.0, t1=0.010)


def test_device_trace_arithmetic():
    t = _trace()
    assert t.launches(bottom_kernel.SYMBOL) == 2
    assert t.device_seconds(bottom_kernel.SYMBOL) == pytest.approx(0.002)
    assert t.busy_s() == pytest.approx(0.004)
    assert t.gaps() == pytest.approx([(0.001, 0.002), (0.004, 0.006),
                                      (0.007, 0.010)])
    spans = [SimpleNamespace(name="pipeline.train", t0=0.0, t1=0.0065),
             SimpleNamespace(name="train.epoch", t0=0.0005, t1=0.0045)]
    got = dict(t.idle_by_span(spans))
    assert got == pytest.approx({"train.epoch": 0.001,
                                 "pipeline.train": 0.002, "host": 0.003})


def test_shares():
    t = SimpleNamespace(device=_trace(), launches=[
        (2, dict(m=3, rows=512, d=11, o=8, gather=False))])
    want = 100 * 2 * (117888 / 3.35e12) / 0.002
    assert readers.roofline_share(t, bottom_kernel, H100) == pytest.approx(
        want)
    assert readers.idle_share(t) == pytest.approx(60.0)
    assert readers.roofline_share(SimpleNamespace(device=None, launches=[]),
                                  bottom_kernel, H100) is None


def test_mfu_readers():
    """train_mfu: 2 jobs of 4 epochs × 100 rows in 0.5 s of
    ``pipeline.train``; score_mfu: 1e6 rows in 10 s."""
    from perfbench.harness.manifest import load_module
    mdl = {"model": "mlp", "n_classes": 2, "bottom_dim": 8,
           "hidden_dim": 64}
    span = SimpleNamespace(name="pipeline.train", duration=0.25)
    jobs = [SimpleNamespace(spans=[span], epochs=4, n_train=100,
                            profiled=False) for _ in range(2)]
    t = SimpleNamespace(jobs=jobs, model=mdl, dims=[11, 11, 10])
    per_row = 2 * 536 + 3 * 3265
    got = load_module("metrics", "train_mfu").read(t, peak=H100)
    assert got == pytest.approx(100 * per_row * 800 / 0.5 / 67e12)
    t = SimpleNamespace(model=mdl, dims=[11, 11, 10], rows_done=10 ** 6,
                        window_s=10.0)
    got = load_module("metrics", "score_mfu").read(t, peak=H100)
    assert got == pytest.approx(100 * 3801 * 1e5 / 67e12)
