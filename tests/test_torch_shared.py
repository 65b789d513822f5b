"""tests/torch_shared.py: a product is built once per run and reads back equal.

The port's costly parity fixtures go through ``torch_shared.shared``; these
tests hold its two promises: a product reads back value for value (types,
dtypes, shapes, the float bits), and under pytest-xdist one build serves
every worker (three processes ask at once, one builds), while without xdist
each call builds as a fixture did before.
"""

import collections
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_shared

TESTS = Path(__file__).resolve().parent


def _same(a, b):
    """Equal value for value, with the same container and scalar types."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, np.generic):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list | tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b


def _product():
    rng = np.random.default_rng(0)
    return {"metrics": {"loss": 0.1 + 0.2, "nan": float("nan"), "big": 1e300, "tiny": 5e-324},
            "grads": {"g": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                            "i": np.arange(5, dtype=np.int32)}},
            "bf": np.float32(1 / 3), "flag": True, "n": 7, "none": None, "name": "fft",
            "shape": (8, 8, 2, 2), "list": [1, (2.5, "x")], 3: "an int key",
            "empty": np.zeros((0, 2), np.float64), "scalar0d": np.asarray(2.0)}


def test_product_reads_back_equal(tmp_path):
    want = _product()
    torch_shared.save(want, tmp_path)
    _same(torch_shared.load(tmp_path), want)


@pytest.mark.parametrize("leaf", [object(), collections.namedtuple("Pair", "a b")(1, 2),
                                  collections.OrderedDict(a=1)])
def test_refuses_what_would_not_read_back(tmp_path, leaf):
    with pytest.raises(TypeError, match="hold no"):
        torch_shared.save({"x": leaf}, tmp_path)


class _Factory:
    """tmp_path_factory's two methods, for a worker whose own base is base."""

    def __init__(self, base):
        self.base = base

    def getbasetemp(self):
        return self.base

    def mktemp(self, name):
        path = self.base / name
        path.mkdir(parents=True)
        return path


def test_without_xdist_every_call_builds(tmp_path, monkeypatch):
    monkeypatch.delenv("PYTEST_XDIST_WORKER", raising=False)
    calls = []
    factory = _Factory(tmp_path)
    for i in range(2):
        workdir, got = torch_shared.shared(factory, f"p{i}", lambda d: calls.append(d) or 41)
        assert got == 41 and workdir == calls[-1] and workdir.parent == tmp_path
    assert len(calls) == 2


def test_under_xdist_one_build_serves_later_calls(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTEST_XDIST_WORKER", "gw0")
    calls = []

    def build(workdir):
        calls.append(workdir)
        (workdir / "rank0.txt").write_text("a rank's output")
        return _product()

    first = torch_shared.shared(_Factory(tmp_path / "popen-gw0"), "job", build)
    second = torch_shared.shared(_Factory(tmp_path / "popen-gw1"), "job", build)
    assert len(calls) == 1
    assert first[0] == second[0] == tmp_path / "torch_shared" / "job"
    assert (second[0] / "rank0.txt").read_text() == "a rank's output"
    _same(second[1], first[1])
    log = (tmp_path / "torch_shared" / "log.txt").read_text().splitlines()
    assert [line.split()[:4] for line in log] == [["job", "built", "by", "gw0"],
                                                  ["job", "read", "by", "gw0"]]


def test_a_failed_build_is_built_again(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTEST_XDIST_WORKER", "gw0")
    factory = _Factory(tmp_path / "popen-gw0")

    def broken(workdir):
        raise RuntimeError("the reference run failed")

    with pytest.raises(RuntimeError, match="reference"):
        torch_shared.shared(factory, "job", broken)
    assert torch_shared.shared(factory, "job", lambda d: [1.5])[1] == [1.5]


_WORKER = """
import sys, time
sys.path.insert(0, {tests!r})
import torch_shared

def build(workdir):
    with open({log!r}, "a") as f:
        f.write("built\\n")
    time.sleep(1.0)
    return {{"x": 2.5}}

class Factory:
    def getbasetemp(self):
        return __import__("pathlib").Path({base!r}) / sys.argv[1]

print(torch_shared.shared(Factory(), "job", build)[1]["x"])
"""


def test_concurrent_workers_build_once(tmp_path):
    """Three processes ask at once: one builds while the others wait on the
    lock, then all read 2.5."""
    log = tmp_path / "builds.log"
    code = _WORKER.format(tests=str(TESTS), base=str(tmp_path), log=str(log))
    env = {**os.environ, "PYTEST_XDIST_WORKER": "gw9"}
    procs = [subprocess.Popen([sys.executable, "-c", code, f"popen-gw{i}"], env=env,
                              stdout=subprocess.PIPE, text=True) for i in range(3)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert outs == ["2.5"] * 3
    assert log.read_text() == "built\n"
