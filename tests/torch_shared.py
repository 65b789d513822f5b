"""Costly test products built once per test run and read by every worker.

Under pytest-xdist with ``--dist load`` the workers take single tests, not
whole files, so every worker that draws one test of a module builds that
module's fixtures again: the JAX reference runs of the port's parity tests
(tens of seconds each) ran up to six times at once. ``shared`` builds such a
product once per run:

* under pytest-xdist (``PYTEST_XDIST_WORKER`` is set), the first worker to
  ask takes an exclusive ``fcntl.flock`` on ``torch_shared/<name>.lock`` in
  the run's shared temporary directory
  (``tmp_path_factory.getbasetemp().parent``, the parent of every worker's
  own), builds the product and writes it as ``torch_shared/<name>/
  product.json`` (the structure) and ``product.npz`` (its arrays); the
  other workers wait on the lock and read the files. A build that raises
  leaves no product, so the next worker builds again and raises the same
  way. ``torch_shared/log.txt`` gets a line a call: the name, built or
  read, by which worker, the seconds waited and spent;
* without xdist it builds the product, as the fixture did before.

A product is a tree of dicts, lists, tuples, None, bools, ints, floats,
strings and numpy arrays or scalars; it reads back equal value for value,
with the same types, dtypes and shapes (floats through JSON's repr, arrays
through ``np.save``). A build gets a directory of its own for files the
product points to (``workdir``), under the shared root under xdist.
"""

from __future__ import annotations

import fcntl
import json
import os
import time
from pathlib import Path

import numpy as np


def _encode(x, arrays):
    # exact types only: a subclass (a namedtuple, an OrderedDict) would read
    # back as its base, so it is refused
    if type(x) is np.ndarray or isinstance(x, np.generic):
        key = f"a{len(arrays)}"
        arrays[key] = np.asarray(x)
        return {"array": key, "scalar": isinstance(x, np.generic)}
    if type(x) is dict:
        return {"dict": [[_encode(k, arrays), _encode(v, arrays)] for k, v in x.items()]}
    if type(x) in (list, tuple):
        return {type(x).__name__: [_encode(v, arrays) for v in x]}
    if x is None or type(x) in (bool, int, float, str):
        return {"value": x}
    raise TypeError(f"shared products hold no {type(x).__name__}")


def _decode(x, arrays):
    if "array" in x:
        a = arrays[x["array"]]
        return a[()] if x["scalar"] else a
    if "dict" in x:
        return {_decode(k, arrays): _decode(v, arrays) for k, v in x["dict"]}
    if "list" in x:
        return [_decode(v, arrays) for v in x["list"]]
    if "tuple" in x:
        return tuple(_decode(v, arrays) for v in x["tuple"])
    return x["value"]


def save(product, path: Path) -> None:
    """Write ``product`` as path/product.json and path/product.npz."""
    arrays = {}
    tree = _encode(product, arrays)
    np.savez(path / "product.npz", **arrays)
    (path / "product.json").write_text(json.dumps(tree))


def load(path: Path):
    """The product ``save`` wrote under ``path``."""
    with np.load(path / "product.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return _decode(json.loads((path / "product.json").read_text()), arrays)


def shared(tmp_path_factory, name: str, build):
    """``build(workdir)``'s product, built once per run and read by every
    xdist worker (module docstring). ``name`` is unique in the run. Returns
    (workdir, product)."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        workdir = tmp_path_factory.mktemp(name)
        return workdir, build(workdir)
    root = tmp_path_factory.getbasetemp().parent / "torch_shared"
    root.mkdir(exist_ok=True)
    workdir = root / name
    t0 = time.perf_counter()
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        waited = time.perf_counter() - t0
        if (workdir / "product.json").exists():
            product, what = load(workdir), "read"
        else:
            workdir.mkdir(exist_ok=True)
            product, what = build(workdir), "built"
            save(product, workdir)
        with open(root / "log.txt", "a") as log:  # who built, who read: one build a name
            log.write(f"{name} {what} by {os.environ['PYTEST_XDIST_WORKER']} after "
                      f"{waited:.1f} s waiting, in {time.perf_counter() - t0 - waited:.1f} s\n")
        return workdir, product
