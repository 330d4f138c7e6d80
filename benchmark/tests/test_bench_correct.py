"""`correct` on small cells, on the CPU: a sound run of each driver comes
out correct; with the timed path broken underneath (`faults.FAULTS`: a
step that returns its state unchanged; an output altered where the step
makes it; in the 4K chain, the deblocker or CAS left out, or a tracker
that reports no motion) it comes out not correct; and the control (the
reference in bfloat16 put in the program's place, judged by the harness)
fails the cell's limits.

The runs skip the harness's look for a chip (`run.execute` on the CPU) and
drive the rest: the driver, the generator, the reference and the
comparison, with the port's plain path at a small size."""


import pytest
import torch

from tiny import tiny_cell

import control
import faults
import run as bench
from harness import manifest

CELLS = ["vs1080_clip", "vs4k_chain_clip", "vs1080_live_60fps", "vs1080_live_x8"]
SECONDS = 1.5
# A sound run's rate at the tiny size, for the control's count of inputs.
TINY_RATE = 40.0


def _run(cell):
    return bench.execute(cell, seed=2**31 + 5, seconds=SECONDS, trace=False, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(tiny_cell(name))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


def test_float32_queue_is_correct():
    # The reference follows the configuration's queue type: the same cell
    # with the stabilizer's float32 queue is judged against float32 planes.
    cell = tiny_cell("vs1080_clip")
    cell.config["filters"][0]["settings"]["queue_dtype"] = "float32"
    res = _run(cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name", ["vs1080_clip", "vs1080_live_60fps"])
def test_state_left_unchanged_is_not_correct(name, monkeypatch):
    faults.FAULTS["state_unchanged"](monkeypatch.setattr)
    res = _run(tiny_cell(name))
    assert not res["correct"]
    assert res["failed"] > 0 or res["checks"]["outputs_compared"]["value"] == 0


@pytest.mark.parametrize("alter", ["moved", "brightened"])
@pytest.mark.parametrize("name", CELLS)
def test_altered_output_is_not_correct(name, alter, monkeypatch):
    faults.FAULTS[alter](monkeypatch.setattr)
    res = _run(tiny_cell(name))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault,number", [("no_deblocking", "deblocking_gap"), ("no_cas", "cas_gap"),
                                          ("still_tracker", "residual_u8")])
def test_chain_stage_left_out_is_not_correct(fault, number, monkeypatch):
    # Each stage the 4K chain's `why` names fails a number.  The shake is
    # widened so that a still tracker leaves several of the tiny frame's
    # pixels uncorrected, as the cell's own shake does at 4K.
    faults.FAULTS[fault](monkeypatch.setattr)
    cell = tiny_cell("vs4k_chain_clip")
    cell.traffic["jitter_px"] = 40.0
    res = _run(cell)
    assert not res["correct"]
    check = res["checks"][number]
    assert check["value"] > check["limit"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_is_not_correct(name):
    # Half of the cell's frame size, under the cell's own limits: at the
    # smallest sizes bfloat16 still holds every pixel coordinate exactly.
    limits = {k: v for k, v in manifest.cell(name).limits.items() if k != "min_compared"}
    cell = tiny_cell(name, size=(540, 960), ring=24, **limits)
    for seed in (1, 2, 3):
        res = control.control(cell, seed, SECONDS, TINY_RATE, torch.device("cpu"))
        assert not res["correct"], res
        assert res["checks"]["outputs_compared"]["value"] >= 1
