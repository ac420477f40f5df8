"""The port imports no jax, and asks for its device explicitly."""

import os
import subprocess
import sys

import pytest
import torch

from rabbitkssd_tpu_torch.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "rabbitkssd_tpu_torch",
    "rabbitkssd_tpu_torch.device",
    "rabbitkssd_tpu_torch.cli",
    "rabbitkssd_tpu_torch.entry",
    "rabbitkssd_tpu_torch.params",
    "rabbitkssd_tpu_torch.formats",
    "rabbitkssd_tpu_torch.seqio",
    "rabbitkssd_tpu_torch.shuffle",
    "rabbitkssd_tpu_torch.glibc_rand",
    "rabbitkssd_tpu_torch.oracle",
    "rabbitkssd_tpu_torch.native",
    "rabbitkssd_tpu_torch.ops.kmer",
    "rabbitkssd_tpu_torch.ops.member",
    "rabbitkssd_tpu_torch.ops.stream",
    "rabbitkssd_tpu_torch.ops._build",
    "rabbitkssd_tpu_torch.ops.distance",
    "rabbitkssd_tpu_torch.ops.intersect",
    "rabbitkssd_tpu_torch.engine.sketcher",
    "rabbitkssd_tpu_torch.engine.dist_engine",
    "rabbitkssd_tpu_torch.engine.setops",
    "rabbitkssd_tpu_torch.parallel.multihost",
    "rabbitkssd_tpu_torch.parallel.sharded",
    "rabbitkssd_tpu_torch.utils.stdheap",
    "rabbitkssd_tpu_torch.utils.timers",
    "rabbitkssd_tpu_torch.utils.trace_report",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print('JAX_LOADED' if 'jax' in sys.modules else 'JAX_ABSENT')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1] == "JAX_ABSENT"


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_phase_writes_profiler_trace(tmp_path, monkeypatch, capsys):
    """KSSD_PROFILE_DIR: each phase leaves a torch.profiler Chrome trace."""
    from rabbitkssd_tpu_torch.utils import timers

    monkeypatch.setattr(timers, "PROFILE_DIR", str(tmp_path / "prof"))
    with timers.phase("tiny phase"):
        torch.arange(10).sum()
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].startswith("tiny_phase.")
    assert "time of tiny phase is:" in capsys.readouterr().err
