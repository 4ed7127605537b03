"""The port's native serving library (nimblephysics_tpu_torch/native): its
seqlock control buffer, single and under concurrent churn, the ticker's
precision, and its golden LCP against the port's PGS (ops/lcp.py
pgs_solve), as tests/test_native.py holds the JAX package's copy. The
library is the port's own, built from its sources at first use."""

import threading
import time

import numpy as np
import pytest
import torch

from nimblephysics_tpu_torch import native
from nimblephysics_tpu_torch.native import RtControlBuffer, lcp_gold, ticker_now, ticker_sleep_until
from nimblephysics_tpu_torch.ops import lcp as lcp_mod


def test_library_is_the_ports_own_build():
    path = native.library_path()
    assert path.parent.parent == native.BUILD_ROOT
    assert path.name == native.LIB_NAME and native.build() == path and path.exists()


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-include", "nptt_missing_header.h"))
    with pytest.raises(RuntimeError, match="building the native library failed") as err:
        native.build()
    assert "nptt_missing_header.h: No such file" in str(err.value)
    assert not any(tmp_path.rglob("*.so"))


def test_rt_buffer_basic():
    buf = RtControlBuffer(horizon=5, na=2)
    assert buf.control_at(0.0) == (None, None)
    u = np.arange(10, dtype=np.float64).reshape(5, 2)
    buf.publish(start_time=1.0, dt=0.1, u=u)
    idx, out = buf.control_at(1.05)
    assert idx == 0 and np.allclose(out, [0, 1])
    idx, out = buf.control_at(1.25)
    assert idx == 2 and np.allclose(out, [4, 5])
    idx, out = buf.control_at(99.0)
    assert idx == 4 and np.allclose(out, [8, 9])  # clamp to plan end
    idx, out = buf.control_at(0.0)
    assert idx == 0  # clamp to plan start
    # a plan made by torch publishes as it is; a wrong shape raises
    buf.publish(2.0, 0.1, torch.full((5, 2), 7.0, dtype=torch.float32))
    assert buf.num_published == 2 and np.all(buf.control_at(2.0)[1] == 7.0)
    with pytest.raises(ValueError, match="shape"):
        buf.publish(2.0, 0.1, np.zeros((4, 2)))


def test_rt_buffer_concurrent_publish_read():
    """A reader always sees one plan's row (never a torn mix of two plans)
    while the publisher swaps buffers at full speed."""
    H, NA = 20, 4
    buf = RtControlBuffer(horizon=H, na=NA)
    stop = threading.Event()
    torn = []

    def publisher():
        k = 0
        while not stop.is_set():
            k += 1
            buf.publish(0.0, 0.01, np.full((H, NA), float(k)))

    def reader():
        while not stop.is_set():
            _, out = buf.control_at(0.05)
            if out is not None and not np.all(out == out[0]):
                torn.append(out.copy())

    threads = [threading.Thread(target=publisher)] + [
        threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join()
    assert buf.num_published > 100
    assert not torn, torn[:3]


def test_ticker_precision():
    t0 = ticker_now()
    ticker_sleep_until(t0 + 0.05)
    elapsed = ticker_now() - t0
    assert 0.0499 <= elapsed < 0.06, elapsed


def _random_contact_lcp(rng, n_contacts, mu=0.6):
    """A PSD contact-structured boxed LCP (tests/test_native.py's)."""
    m = 3 * n_contacts
    G = rng.standard_normal((m, m + 3))
    A = G @ G.T / m + 1e-3 * np.eye(m)
    b = rng.standard_normal(m)
    lo = np.zeros(m)
    hi = np.full(m, 1e20)
    fscale = np.zeros(m)
    findex = np.full(m, -1, dtype=np.int32)
    for k in range(n_contacts):
        for d in (1, 2):
            lo[3 * k + d] = 0.0
            hi[3 * k + d] = 0.0
            fscale[3 * k + d] = mu
            findex[3 * k + d] = 3 * k
    return A, b, lo, hi, fscale, findex


def test_lcp_gold_complementarity():
    rng = np.random.default_rng(0)
    for trial in range(5):
        A, b, lo, hi, fscale, findex = _random_contact_lcp(rng, 3)
        _, resid = lcp_gold(A, b, lo, hi, fscale, findex)
        assert resid < 1e-7, (trial, resid)


def test_port_pgs_matches_native_gold():
    """The port's PGS at 400 sweeps agrees with the deeply converged native
    solver on contact-structured problems."""
    rng = np.random.default_rng(1)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    for trial in range(5):
        A, b, lo, hi, fscale, findex = _random_contact_lcp(rng, 2)
        x_gold, resid = lcp_gold(A, b, lo, hi, fscale, findex)
        assert resid < 1e-7
        x_dev = lcp_mod.pgs_solve(t(A), t(b), t(lo), t(hi), t(fscale),
                                  torch.zeros(len(b), dtype=torch.float64),
                                  tuple(int(i) for i in findex), 400)
        np.testing.assert_allclose(x_dev.numpy(), x_gold, atol=2e-4, err_msg=f"trial {trial}")
