"""The differential fuzzer (scripts/torch_diff_fuzz.py) on the CPU.

* Four fixed trials of ``--against jax``: the port's CLI on the CPU
  against the JAX package's CLI, every leg exactly equal (sketch hash
  sets and files, alldist and dist rows, union/sub/merge, convert both
  ways, ``info -F``).  Between them they draw a 64-bit config (K = 24,
  k - l >= 9), FASTQ with ``-Q`` and ``-n``, a blocked-strip knob leg
  (two sparse strips of 128 genomes) and the set-algebra leg, which
  every trial runs; their knob legs are ``_int_mm`` counting, the
  chunked reader and the legacy paths.  Twenty-five more trials are
  ``slow``.
* ``--against cpu --device cpu`` in a subprocess: one trial passes and
  the process loads no jax and no ``rabbitkssd_tpu`` module.
* ``--device cuda`` without a card raises; it never runs on the CPU.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_diff_fuzz.py")

_spec = importlib.util.spec_from_file_location("torch_diff_fuzz", SCRIPT)
fuzz = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fuzz)

# (seed, trial): what each draws
FIXED = {
    (1, 3): "L1K12S5, 64-bit FASTA, -M 1, knob matmul",
    (26, 3): "L1K13S5, 64-bit FASTQ -Q 41 -n 2, knob stream-threshold",
    (7, 3): "L1K13S5, 64-bit, 150+ genomes, knob block128-sparse",
    (5, 1): "L2K15S5, 64-bit FASTA, knob legacy",
}
SLOW = [(100 + i, i) for i in range(25)]


def _trial(tmp_path, seed, t):
    rec = fuzz.run_trial(seed, t, "jax", "cpu", str(tmp_path))
    assert "union+sub+merge" in rec["legs"] and rec["files_compared"] > 20
    return rec


def test_fixed_trials_cover_the_space():
    """The fixed trials draw what their names say (no corpus is made)."""
    cfgs = {key: fuzz.draw_trial(*key, "jax")[0] for key in FIXED}
    assert all(c["use64"] for c in cfgs.values())
    fq = cfgs[(26, 3)]
    assert fq["fastq"] and "-Q" in fq["qflags"] and "-n" in fq["qflags"]
    assert cfgs[(7, 3)]["knob"] == "block128-sparse"
    assert float(cfgs[(7, 3)]["D"]) < 1.0  # else the strips stay dense
    assert [cfgs[k]["knob"] for k in ((1, 3), (26, 3), (5, 1))] == [
        "matmul", "stream-threshold", "legacy"]


@pytest.mark.parametrize("seed,t", list(FIXED), ids=list(FIXED.values()))
def test_trial_port_equals_jax(tmp_path, seed, t):
    rec = _trial(tmp_path, seed, t)
    assert rec["config"]["knob"] and any(
        leg.startswith("knob ") for leg in rec["legs"])
    if rec["config"]["knob"].startswith("block"):
        assert rec["config"]["genomes"] >= 150


@pytest.mark.slow
@pytest.mark.parametrize("seed,t", SLOW)
def test_trial_port_equals_jax_slow(tmp_path, seed, t):
    _trial(tmp_path, seed, t)


def test_cpu_mode_loads_no_jax_package(tmp_path):
    """The card's mode, run on the CPU device: one trial passes, and the
    process loads no jax and no rabbitkssd_tpu module."""
    env = dict(os.environ, PYTHONPATH=REPO, KSSD_TIMER="0")
    proc = subprocess.run(
        [sys.executable, SCRIPT, "--against", "cpu", "--device", "cpu",
         "--trials", "1", "--seed", "9", "--root", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rep["failures"] == [] and rep["passed"] == 1
    assert "forced overflow" in rep["trial_legs"][0]
    assert rep["jax_modules_loaded"] == 0
    assert rep["launches"] == {"member_bitmap": 0, "stream_keep": 0,
                               "stream_compact": 0}
    assert os.listdir(tmp_path) == []  # the passing trial deleted its dir


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        fuzz.main(["--against", "cpu", "--device", "cuda", "--trials", "1"])
