"""Import hygiene and no-fallback rules of the PyTorch port.

* every module of vosk_tts_tpu_torch imports without JAX or the JAX package;
* entry points run on the card: without CUDA, ``Model`` raises;
* a kernel wrapper reaches its plain version only for a tensor on the CPU
  (checked on the source here; tests/test_torch_cuda_kernels.py launches
  the kernels with the plain versions disabled, on the card).
"""

import ast
import inspect
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from vosk_tts_tpu_torch.ops import ddsconv_fused as ddf
from vosk_tts_tpu_torch.ops import flash_attention as fa
from vosk_tts_tpu_torch.ops import mas

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = textwrap.dedent("""
    import importlib, pkgutil, sys
    import vosk_tts_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "vosk_tts_tpu"))
    print(len(names), bad)
""")


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    count, bad = r.stdout.strip().split(" ", 1)
    assert int(count) >= 15 and bad == "[]", r.stdout


_IMPORT_TRAIN = textwrap.dedent("""
    import importlib, sys
    for name in ("data", "driver_common", "losses", "run_vits2", "vits2_train", "stabletts_train",
                 "stabletts_data", "run_stabletts", "vc_train", "vc_data", "run_vc",
                 "gpt_sovits_data", "gpt_sovits_train", "scaled_adam", "run_gpt_sovits"):
        importlib.import_module("vosk_tts_tpu_torch.train." + name)
    importlib.import_module("vosk_tts_tpu_torch.models.discriminators")
    importlib.import_module("vosk_tts_tpu_torch.models.wavlm")
    importlib.import_module("vosk_tts_tpu_torch.ops.resample")
    importlib.import_module("vosk_tts_tpu_torch.ops.rvq")
    print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "vosk_tts_tpu")))
""")


def test_train_imports_no_jax():
    """The training package (train/, the discriminators, WavLM and the
    resampler of the SLM loss, the codebook's buffers) in a fresh process."""
    r = subprocess.run([sys.executable, "-c", _IMPORT_TRAIN], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


_IMPORT_VOCODERS = textwrap.dedent("""
    import importlib, sys
    for name in ("bigvgan", "vocoder"):
        importlib.import_module("vosk_tts_tpu_torch.models." + name)
    print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "vosk_tts_tpu")))
""")


def test_vocoders_import_no_jax():
    """The vocoders (models/bigvgan.py, models/vocoder.py) in a fresh process."""
    r = subprocess.run([sys.executable, "-c", _IMPORT_VOCODERS], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


_IMPORT_EVAL = textwrap.dedent("""
    import importlib, sys
    for name in ("eval", "eval.harness", "eval.speaker_embed", "eval.speaker_train",
                 "models.whisper", "utils.profiling", "utils.repro", "utils.plotting",
                 "tools", "tools.eval_tts", "tools.build_examples",
                 "tools.train_speaker_embedder"):
        importlib.import_module("vosk_tts_tpu_torch." + name)
    print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "vosk_tts_tpu")))
""")


def test_eval_imports_no_jax():
    """The eval harness and speaker embedders, Whisper, the profiling,
    repro and plotting utilities and the tools, in a fresh process."""
    r = subprocess.run([sys.executable, "-c", _IMPORT_EVAL], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


def test_port_sources_name_no_jax():
    """No source of the port, and not chip_smoke.py, imports JAX or the JAX
    package (also where an import sits inside a function)."""
    files = sorted((ROOT / "vosk_tts_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "vosk_tts_tpu"), (path, n)


def test_model_needs_cuda_without_device(tmp_path):
    from vosk_tts_tpu_torch.api import Model

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(tmp_path)


@pytest.mark.parametrize("wrapper,plain", [(fa.banded_flash_attention, "banded_attention_plain"),
                                           (ddf.ddsconv_fused, "ddsconv_plain"),
                                           (fa.global_flash_attention_rope, "global_attention_plain"),
                                           (fa.global_flash_attention_packed, "global_attention_plain"),
                                           (fa.global_flash_attention, "global_attention_plain"),
                                           (mas.mas_path, "maximum_path_plain")])
def test_wrapper_takes_plain_only_for_cpu(wrapper, plain):
    """The plain version appears once in the wrapper: as the return of its
    first statement, ``if not <x>.is_cuda``; the rest launches the kernel
    or raises, with no try/except around it."""
    fn = ast.parse(textwrap.dedent(inspect.getsource(wrapper))).body[0]
    body = [s for s in fn.body if not (isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant))]
    first = body[0]
    assert isinstance(first, ast.If) and isinstance(first.test, ast.UnaryOp)
    assert isinstance(first.test.op, ast.Not) and first.test.operand.attr == "is_cuda"
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == plain]
    assert len(calls) == 1 and calls[0] in list(ast.walk(first))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    assert any(isinstance(n, ast.AugAssign) and getattr(n.target, "attr", None) == "launches"
               for n in ast.walk(fn))
