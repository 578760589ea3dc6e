"""The port's examples (``examples/torch_*.py``) on the CPU at small
arguments, each through its ``main(argv)`` with ``--device cpu``: each
one's own checks pass (ranks, labels and tree analytics against the
port's serial oracles; every request served; the loss falling; GAT
beating random; probabilities and candidate ids). ``torch_quickstart``
prints the same counts and checks as the reference's
``examples/quickstart.py`` at the same ``--n`` (run in a subprocess),
its timings masked. The examples' tensors are small, so each test runs
torch on one thread: several threads a process only contend on a busy
host."""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _masked(text: str) -> list[str]:
    return [re.sub(r"\s*[0-9.]+ ms", " <t> ms", line)
            for line in text.splitlines() if line.strip()]


def test_quickstart_prints_the_references_counts_and_checks(capsys):
    argv = ["--n", "20000", "--splitters", "512"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    ref = subprocess.Popen([sys.executable, str(ROOT / "examples/quickstart.py")] + argv,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                           env=env, cwd=ROOT)
    try:
        _example("torch_quickstart").main(argv + ["--device", "cpu"])
        got = capsys.readouterr().out
        out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    assert _masked(got) == _masked(out)
    assert "verified against serial Euler walk" in got


def test_serve_lm_serves_every_request(capsys):
    _example("torch_serve_lm").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("6 requests in ")


def test_train_lm_loss_falls_and_resumes(tmp_path, capsys):
    argv = ["--device", "cpu", "--steps", "8", "--checkpoint-dir", str(tmp_path)]
    _example("torch_train_lm").main(argv)
    out = capsys.readouterr().out
    assert "steps 0..7" in out
    _example("torch_train_lm").main(argv)  # a finished run: nothing left to do
    assert "holds a finished run" in capsys.readouterr().out


def test_gnn_cora_beats_random(capsys):
    _example("torch_gnn_cora").main(["--device", "cpu", "--steps", "30",
                                     "--nodes", "800", "--edges", "3200"])
    assert "final accuracy" in capsys.readouterr().out


def test_recsys_serving_scores_and_retrieves(capsys):
    _example("torch_recsys_serving").main(["--device", "cpu", "--steps", "4",
                                           "--batch", "64"])
    out = capsys.readouterr().out
    assert "retrieval over 100,000 candidates" in out
