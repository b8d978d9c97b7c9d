"""The kernel library's build and launch counters under threads (CPU).

The serving frontends call the engine from a worker, a writer and a
reader thread, so two threads may launch their first kernel together
and launches from several threads may be counted at once. These tests
stand in for the card: the build and the C library are replaced by
counting fakes, so what is checked is the locking in
``repro_torch.kernels._build``, not the kernels.
"""
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

THREADS = 8
LAUNCHES = 10_000


class _FakeFn:
    """A C launcher stand-in: accepts argtypes/restype and returns 0."""

    def __call__(self, *args):
        return 0


class _FakeLib:
    """A ``ctypes.CDLL`` stand-in with every launcher of ``KERNELS``."""

    def __init__(self, path):
        self.path = path
        for name in list(_build.KERNELS) + ["repro_error_string"]:
            setattr(self, name, _FakeFn())


def _run_together(fn, n=THREADS):
    """Start ``n`` threads on ``fn`` at once; join each with a timeout."""
    start = threading.Barrier(n)
    errors = []

    def body():
        try:
            start.wait(timeout=30)
            fn()
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=body, daemon=True) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "a thread did not finish within 60 s"
    assert not errors, errors


def test_library_builds_once_from_many_threads(monkeypatch, tmp_path):
    builds = []

    def fake_build():
        builds.append(threading.get_ident())
        time.sleep(0.05)  # widen the window two unguarded builds would share
        return tmp_path / "libfake.so"

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", _FakeLib)
    libs = []
    _run_together(lambda: libs.append(_build.library()))
    assert len(builds) == 1, f"{len(builds)} builds for {THREADS} threads"
    assert len(libs) == THREADS and all(lib is libs[0] for lib in libs)
    assert _build.library() is libs[0]  # later calls take the loaded one


def test_launch_counts_are_exact_under_threads(monkeypatch):
    """8 threads x 10,000 launches through ``launch``: no count is lost,
    even with the interpreter switching threads as often as it can."""
    fake = _FakeLib("fake")
    monkeypatch.setattr(_build, "library", lambda: fake)
    old = sys.getswitchinterval()
    cpu = torch.device("cpu")
    _build.reset_launch_counts()
    sys.setswitchinterval(1e-6)
    try:
        def body():
            for _ in range(LAUNCHES):
                _build.launch("hll_accumulate", cpu)
        _run_together(body)
    finally:
        sys.setswitchinterval(old)
    counts = _build.launch_counts()
    _build.reset_launch_counts()
    assert counts["hll_accumulate"] == THREADS * LAUNCHES
    assert sum(counts.values()) == THREADS * LAUNCHES
