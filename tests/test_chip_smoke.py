"""chip_smoke.py's phase functions at a tiny size on the CPU (Pallas in
interpret mode); the script itself runs them at full size on the card."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent.parent))

import chip_smoke  # noqa: E402

TINY = dict(n=300, image_size=(64, 48))


def test_phases_at_tiny_size(capsys):
  device = chip_smoke.run(platform="cpu", steps=2, iters=1, **TINY)
  assert device["platform"] == "cpu"
  out = capsys.readouterr().out
  for phase in ("phase 1", "phase 2", "phase 3", "phase 4", "phase 5"):
    assert phase in out
  assert "FAIL" not in out
  assert "memory_analysis" in out


def test_device_phase_rejects_other_platform():
  with pytest.raises(chip_smoke.PhaseError):
    chip_smoke.phase_device("gpu")


def test_data_parallel_phase_on_virtual_devices(capsys):
  s = chip_smoke.make_setup(**TINY)
  chip_smoke.phase_data_parallel(s, devices=4)
  out = capsys.readouterr().out
  assert "FAIL" not in out and "sharded projection" in out


def test_card_info_is_a_string():
  assert isinstance(chip_smoke.card_info(), str)
