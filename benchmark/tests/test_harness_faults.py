"""A whole run but the look for a card, on the CPU at a small size, with
the timed path broken underneath: ``correct`` has to come out false for
each fault a cell can have (a cell on one chip has no exchange between
chips to leave out), and true with nothing broken. Each cell's faults are
found by its traffic's driver name, as a run finds the driver; queued
cells (``conftest.QUEUED``) are held to the same."""

import pytest

from benchmark import harness as H
from benchmark.faults import FAULTS, planted
from benchmark.run import run_cell

ATTACK = dict(
    config_overrides={"prj_im_sz": [32, 32], "cam_im_sz": [224, 224],
                      "classifier_crop_sz": [224, 224]},
    traffic_overrides={"d_threshes": [5], "targets_per_config": 1,
                       "iters": 4, "check_steps": 2, "warmup_iters": 1},
    iters=4)
TRAIN = dict(
    config_overrides={"prj_im_sz": [32, 32], "cam_im_sz": [32, 24]},
    traffic_overrides={"batch_size": 4, "train_pairs": 16, "valid_pairs": 8,
                       "valid_rate": 5, "max_iters": 20,
                       "window_check": {"at": 1, "steps": 3}},
    iters=5)
PERCAL = dict(
    config_overrides={"prj_im_sz": [32, 32], "cam_im_sz": [224, 224],
                      "classifier_crop_sz": [224, 224]},
    traffic_overrides={"targets_per_config": 3, "iters": 4,
                       "check_steps": 3},
    iters=4)
CELLS = {"resnet18-attack": ATTACK, "pcnet-train": TRAIN,
         "resnet18-percal": PERCAL}


def _run(workload, seed):
    return run_cell(workload, seed, None, device="cpu",
                    **CELLS[workload])[0]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload, queued_cells):
    result = _run(workload, 2 ** 31 + 21)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "cpu"
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(workload, fault, queued_cells):
    driver = H.cell_files(workload)[3]["driver"]
    with planted(driver, fault):
        result = _run(workload, 2 ** 31 + 22)
    assert not result["correct"], result["checks"]


def test_a_driver_without_faults_is_refused():
    with pytest.raises(FileNotFoundError, match="faults/no_such_driver.py"):
        planted("no_such_driver", "unchanged")
